#!/usr/bin/env python3
"""Drive the PyTorch port's hybrid search on one NVIDIA card and check it.

    python3 chip_smoke.py            # all phases (one card, ~10-15 min)
    python3 chip_smoke.py --quick    # build + kernel-vs-twin checks only
    python3 chip_smoke.py --profile  # all phases, and a profile of each path

Phases, one line of output each (any failed check raises, exit code != 0),
run in the order 1, 2, 3, 6, 7, 10 (the kernel checks; ``--quick`` stops
there), then 4, 5, 12, 13, 8, 9, 11, 14, 15, 16, 17, 18, 19, 20, 21, 22,
23 (the paths):

1. environment: the card, torch and CUDA versions, the kernel build (nvcc,
   ``openintel_tpu_torch/csrc``) and the C++ query planner;
2. kernel A (``csrc/i8_top2g_tma.cu``, TMA + wgmma, two stages) and its
   A/B control, the ``mma.sync`` kernel of ``csrc/i8_top2g.cu``, against
   their plain twin:
   candidate cells bit-identical over groups {1, 2, auto, 5}, both step
   widths, padding;
3. kernel B (``csrc/fused_topk_v2.cu``, its ``cp.async`` ring) and its A/B
   controls, the first version (``csrc/fused_topk.cu``) and, for bf16 at
   k <= 32, the same call on the TMA + wgmma stream (``route="stream"``),
   against their plain twin:
   f32 and bf16, k in {10, 32}, k > n_docs, exactly duplicated scores, B
   8/37/300; v2 alone at D 100 (zero-padded to 112 columns), 1,536 and at
   k 1,024;
4. the main path at full width: 1.25M docs x 384 (bf16 store), the hybrid
   retriever auto-selected to int8, 4 sub-batches of 256 queries through
   prepare -> run_prepared_device -> finalize_prepared; results against the
   plain-twin path, recall@10 against the exact path, per-batch time;
   kernel A alone against v1 (5 alternating rounds of 10 launches) and its
   fold stage alone;
5. text requests: ``HybridRetriever.build`` on ~20k generated docs (kernel B)
   and ``search`` on query strings, against the plain path; kernel B v2
   against v1 at the text path's call (shape a: B=15, N=20k, f32, k=10);
12. the small-corpus path at full width: phase 4's embeddings cut to
   98,304 docs (its own postings index of that size), stored as bf16 and
   as f32, the auto-selected kernel B arm, 4 sub-batches of 256; results
   against the plain-twin path and the exact path (near-tie rule),
   recall@10, per-batch time; kernel B v2 against v1 at shapes b (B=256,
   N=20k, f32, k=32), c-f32 and c-bf16 (B=256, N=98,304, k=32), each with
   its bound and the two-call yardstick ``torch.topk(torch.matmul)``, and
   at c-bf16 the stream route against the served ring in 5 alternating
   rounds;
13. every arm (int8, fast, int4, pallas) at D=100 on the card, equal to its
   plain-twin path (the feature axis zero-padded at load), and ``dot_only``
   (kernel S, the features padded per call) equal to its twin;
6. kernel D (bf16: ``csrc/turbo_bf16_tma.cu``, TMA + wgmma; f32:
   ``csrc/turbo_f32.cu``) and its bf16 A/B control (``turbo_f32.cu``)
   against their plain twin, f32 and bf16:
   cells bit-identical on dyadic operands, within one score step (2**-15)
   on random rows, and the ``dense_topk_fast`` decode under the same rule,
   each decoded value its id's score truncated to a step;
7. kernels E1/E2 (``csrc/turbo_i4_tma.cu``, TMA, an unpack in shared
   memory and wgmma) and their A/B control, the ``mma.sync`` kernel of
   ``csrc/turbo_i4.cu``, against their plain twin: cells and
   ``dense_topk_fast_i4`` bit-identical, slots 1 and 2, random and
   tie-heavy operands;
8. the ``kernel="fast"`` path at full width, on phase 4's corpus and
   queries: kernel D per sub-batch; results against the plain-twin path
   (equal wherever the dense arms are equal, the dense arms within one
   score step), recall@10 against the exact path, per-batch time, kernel D
   alone against its twin and against v1 (5 alternating rounds);
9. the ``kernel="int4"`` path at full width, on the same corpus: kernel E2
   per sub-batch; results equal to the plain-twin path, recall@10, per-batch
   time; the public op ``dense_topk_fast_i4(slots=1)`` (kernel E1) on one
   sub-batch; E2 and E1 alone against their twin and against v1 (5
   alternating rounds), with E2's stream and merge kernels by the profiler;
10. kernels C1/C2 (``csrc/turbo_i8_tma.cu``, TMA + wgmma) and S
   (``csrc/dot_only_tma.cu``, the same stream) and their A/B controls, the
   ``mma.sync`` kernels of ``csrc/turbo_i8.cu`` and ``csrc/dot_only.cu``,
   against their plain twins: cells, ``dense_topk_fast_i8`` (slots 1 and 2,
   k=32 and beyond capacity) and the wrapping lane sums bit-identical, on
   random, tie-heavy and saturated operands; the new C kernels also at
   B=256 (C1 in 2-block clusters), C2 with 1 and 16 parts per super; S also
   at B 45/128/256/320 (paired and unpaired at 256) and D 112/384/1,536;
   and a probe of whether the tensor cores' s32 adds wrap (S forced to
   runs whose sums pass int32);
11. the candidate-pass measurement path at full width, on phase 4's corpus
   and queries: the cores of the three tools in
   ``openintel_tpu_torch/tools`` (kernel S, C1, C2 and A per sub-batch),
   ``dense_topk_fast_i8`` against its plain path, recall@10 after rescore
   of the per-super pass against the grouped kernel A's, C2, C1 and S alone
   against their twin and against v1 (5 alternating rounds), S also paired
   against unpaired, and beside it the two-call yardstick (``torch._int_mm``
   then the per-lane sum);
14. pipelined serving at full width: ``PipelinedSearcher(depth=2)``
   (``openintel_tpu_torch/serving.py``) over phase 4's corpus and int8 arm,
   8 waves of 4 x 256 queries by phase 4's generator, against the
   sequential loop in turns: every wave bit-identical to
   ``run_prepared(prepare(wave))``, kernel A once per sub-batch; queries a
   second of both, ``prepare`` and the step alone per wave, and each
   stage's host time inside the pipeline (the two threads' contention);
15. coalesced serving: 8 concurrent callers of 64 query strings each for
   ~5 s through ``BatchCoalescer(retr.search, max_batch=256,
   max_wait_ms=2.0)``: each caller's first and last result equal to a
   direct search of its strings (near-tie rule), ``batches_run``,
   ``queries_run``, queries a second, the callers' p50 and p99 latency and
   the waves' sizes and search times;
16. filtered search (``filter_mask``, ``filter_group``) on phase 4's corpus
   and queries through phase 14's int8 retriever: masks of 50, 10, 5 and
   1 % (``c_fetch`` 64 or 128, 512, 1,024, 1,024): each sub-batch's
   over-fetched dense pool, before the compaction, bit-identical to its
   plain pool (at 1 % every pool starves and both results are the
   fallback's, so the pools are what hold kernel A there), each result
   bit-identical to the filtered plain-twin path, no masked id, recall@10
   against the exact
   filtered hybrid (masked exact dense arm over the stored rows, f32
   queries, the same mask-aware plan and fusion) >= 0.95, the step beside
   the unfiltered step, the masked ``prepare`` per query, the starved rows
   and their fallback's time, kernel A once per sub-batch; kernel A at
   group 5 (1,024 candidates) against its twin and v1 and the rescore of
   1,024 candidates timed; an include-list of 20 docs and a 0.01 % mask,
   every pool starved, equal to the exact filtered hybrid; 4 mask rows
   round-robin over the queries, each query equal to a single-mask search
   of its row; the fast (kernel D) and int4 (E2) arms and the small
   corpus's pallas arm (B, 98,304 docs) at 50, 5 and 1 %, each pool (D at
   k up to 1,024, E2 at a fetch of 4,096, B at k = 1,024) against its
   plain pool and each result against its plain path (phases 3, 8, 9 and
   12's rules) with no masked id; a
   ``PipelinedSearcher`` stream of unfiltered, single-mask and grouped
   waves, each equal to the sequential path; and 8 ``BatchCoalescer``
   callers (two tenant masks, two callers each, and 4 unfiltered) for 2 s,
   each equal to a direct search at its wave's width and masks;
17. serving a saved index from the port's entry points, on phase 4's
   corpus (kernel A) and phase 12's (kernel B): the pair saved with
   ``index.checkpoint.save_index`` to a temporary directory and loaded
   back bit-equal, a retriever over it bit-identical to phase 4's on 256
   query strings; ``search`` through the CLI in this process (``main``,
   plain and with ``--exclude-ids``) equal to a direct search;
   ``mcp.server.build_server`` and ``handle`` on ``search_corpus`` for 8
   concurrent callers of 64 strings for 3 s, all unfiltered, then half
   with per-query ``filters``, each response equal to a direct search at
   its wave's width and masks, and one call at k = 1,000 (2,000
   candidates, kernel A at group 3) equal to the plain route; the live
   corpus (``--updatable``): 2,048 docs added and 1 % of the ids deleted
   through the tools, 256 strings through ``search_corpus`` bit-identical
   to ``search(plain=True)``, no deleted id, recall@10 against the exact
   combined index (``merge_postings``, the concatenated rows, f32 queries,
   the tombstones, RRF) >= 0.95, its step beside the frozen index's and
   the host compaction's time; on the small corpus the live corpus equal
   to ``HybridRetriever(fusion="rrf")`` over the combined index (near-tie
   rule), ``compact_corpus`` with ``save`` served equal by a fresh server,
   the pallas hybrid refused at k = 1,000 before any launch, and
   ``index`` on phase 5's texts then ``search`` equal to
   ``HybridRetriever.build``;
18. the encoder loop at the full width of the model the repo ships (the
   CLI's default ``EncoderConfig``: vocab 32,768, dim 256, depth 4, heads
   4, 11.57M parameters) on the encoder quality run's corpus
   (``synthetic_synonym_corpus(100_000, n_concepts=2000)``, batch 96, lr
   1.5e-3, flip_p 0.5; 200 steps of its 8,000): ``train_encoder`` on the
   card, its loss falling, and one more step resumed from its checkpoint
   on the card and on the CPU, the weights within 1e-5; 2,048 docs encoded
   on the card against the port on the CPU (f32 within 1e-5, a bf16
   config within 2e-2); ``index --encoder`` through the CLI, split into
   tokenising, encoding, the BM25 build and the save; ``search --encoder``
   on 256 strings (128 synonym-flipped, 128 exact) equal to a direct
   search (near-tie rule), kernel A's cells at 256 x 100,000 x 256
   bit-identical to its twin, recall@10 against the exact path >= 0.95
   and the neural dense arm's recall against the generator's labels
   (printed, no limit); the same with ``--kernel pallas``, kernel B at
   k = 20 held to its twin; ``build_server(index, encoder)`` under 8
   callers, each response equal to a direct search; ``--updatable``: 512
   texts embedded on the card by ``index_documents``, 1 % deleted, a
   search equal to the plain route; ``search --mesh 2x4`` beyond the one
   card refused;
19. ROADMAP item 12 on phase 18's corpus, checkpoint and index:
   ``train --reranker --analyzer`` through the CLI (100 reranker steps of
   8 queries x 4 candidates warm-started from the encoder, 200 analyzer
   steps of 64 on the frozen encoder; both losses falling, the encoder's
   checkpoint unchanged, the card's share of a step by the profiler);
   ``search --rerank`` of 256 strings (128 synonym-flipped) through the
   CLI with kernel A (auto) and kernel B (``--kernel pallas``) beneath,
   each result equal to ``rerank_search_result`` over the un-reranked
   search (near-tie rule) and a permutation of its top-10, the first
   stage and the reranker timed apart; 512 pairs scored on the card and
   the CPU (f32 within 1e-5, a bf16 config within 2e-2);
   ``build_server(rerank=...)`` under 8 callers x 64 strings, each
   response equal to a direct rerank, and the live corpus reranked;
   ``evaluate --encoder --rerank`` on 20,000 docs and 512 self-labelled
   queries (kernel B; the four rows printed, no limit); the lexicon's
   device path at 100,000 posts and at 512 bit for bit its NumPy twin;
   the trained analyzer on 100,000 posts on the card against the CPU
   (1e-5); ``analyze_batch`` over 64 tickers x up to 2,000 signals against
   the scalar engine and the CPU run, ``aggregate_batch`` at 1,024 x 1,024
   timed; ``atr_batch`` over 512 tickers x 250 bars against the CPU run
   and the scalar ``atr``, and ``risk_screen`` over them;
20. ROADMAP item 14, the analysis surface, on phase 18's index and
   checkpoint and phase 19's analyzer head: ``doctor`` and ``doctor
   --index`` as subprocesses (status ok, the card and the kernel library
   named); ``analyze`` (json, table, ``--analyzer``), ``scan``, ``compare``
   under each ``--rank-by``, ``risk`` over 1 and 512 tickers (one
   ``atr_batch`` on the card) and ``pulse`` without a bearer, each a
   subprocess on the card, its JSON equal to ``--device cpu``'s (floats
   within 1e-6; the analyzer's within 1e-5) and the reference's goldens
   held, each call's start-up and work logged; the analysis tools in
   process over in-script sources: ``scan_watchlist`` over 100 tickers x
   100 posts (the lexicon on the host, one ``aggregate_batch`` on the
   card) and 16 x 600 (the lexicon on the card), ``compare_tickers``
   under each ``rank_by``, ``analyze_ticker``, ``risk_frame`` and
   ``list_sources``, each equal to the CPU's and each report to the
   scalar engine's; ``build_server(offline=True, index, encoder)``: 8
   ``search_corpus`` callers alone and beside 2 ``scan_watchlist`` loops
   (q/s and p50/p99 both ways, each response equal to a direct search);
   ``mcp --offline --index`` over stdio as a subprocess;
21. ROADMAP item 13, sharded serving (``openintel_tpu_torch.parallel``), on
   phase 4's corpus and queries: ``ShardedHybridRetriever`` over a 1 x 4
   mesh of the one card (``make_mesh(devices=[card] * 4)``, shards of
   327,680 docs, int8 auto): kernel A 4 times per sub-batch, the results
   bit-identical to the mesh's plain-twin run, recall@10 against the exact
   path >= 0.95, ``mode="bm25"`` bit-identical to one card's BM25 arm, a
   2 x 4 grid bit-identical to 1 x 4; the sharded step beside one card's
   in turns, the host plan and its split, kernel A per shard launch
   against its bound, the gather and merge; the exact arm (kernel B per
   shard, 98,304 docs in 4 x 24,576) equal to one card's kernel B search
   (near-tie rule); masks of 10 and 1 % and 4 per-query mask rows: no
   masked id, bit-identical to the plain run, recall@10 against the exact
   filtered hybrid, the starved rows through ``sharded_dense_topk_masked``
   equal to the exact fallback and (1 %) to one card's filtered search;
   two gloo ranks on the card (a cell each of a 1 x 2 mesh) and a
   one-rank NCCL world, each a process over the saved pair, equal to each
   other and to the in-process 1 x 2 mesh bit for bit, their step and
   the all_gather's share; ``search --mesh 1`` through the CLI, ``--mesh
   4`` refused with the reference's text, ``mcp --offline --index --mesh
   1 --updatable`` over stdio (add, find, delete), ``search --mesh 2
   --coordinator`` as 2 CPU processes equal to the in-process CPU mesh;
   the sharded live corpus (2,048 added, 1 % deleted, compacted in place)
   bit-identical to its plain runs with recall@10 >= 0.95 against the
   exact combined index;
22. ROADMAP item 13b, the encoder's tensor parallelism
   (``openintel_tpu_torch.parallel.tensor``), on phase 18's corpus and
   settings at the default ``EncoderConfig``: 20 steps on the card, then
   over a 1 x 4 and a 2 x 2 mesh of the one card
   (``make_mesh(devices=[card] * 4)``) from the same seed, every step's
   loss within rtol 2e-3, atol 2e-4 of the card's (the reference's mesh
   test) and the final weights' largest difference; each mesh's step
   against one card's in turns, with the launches a step and the share of
   the device time in the cross-cell copies and sums by the profiler; the
   1 x 4 run's gathered checkpoint with one card's keys and shapes,
   resumed one step on the card and on the CPU (weights within 1e-5; the
   one CPU run of the phase) and on the 2 x 2 mesh (the loss within the
   mesh tolerance); ``train --mesh 1xN`` through the CLI on the N cards
   there are (the mesh line, a checkpoint that loads) and ``--mesh 2x4``
   beyond them refused with the reference's text; the served path's
   recall@10 against the exact path over the 20-step checkpoints' indexes
   (one card's and 1 x 4's; printed, no limit); the 1 x 4 run resumed on
   its mesh to phase 18's 200 steps, its loss falling; ``index
   --encoder`` of the 100,000 docs with that checkpoint and ``search
   --encoder`` through the CLI and the library path as in phase 18
   (kernel A's cells and kernel B against their twins, recall@10 against
   the exact path >= 0.95);
23. the measurement tools of the reference's scripts
   (``openintel_tpu_torch.tools``): kernel C2 at B = 512 and 1,024 over
   32,768 docs, its cells and ``dense_topk_fast_i8`` bit-identical to the
   twin and timed beside B = 256; ``dense_topk_fast_i4`` (kernel E2) on the
   int4 corpus of scales 32 and 40 at B = 256 and 1,024, k = 128 and 256,
   cells and decode bit-identical to the plain run; then each tool's
   command once at a small size on the card, its JSON stamped ``cuda`` and
   the card: ``profile_planner`` (65,536 docs), ``coalescer`` (4 callers
   for 1 s) and ``arrival`` (2 fractions of 0.5 s) on the int8 arm over
   131,072 docs (kernel A), ``encoder_quality`` (5,000 docs, 10 steps, 10
   reranker steps), ``fusion_ab`` (2,000 docs), ``sharded_overhead`` (its
   shape, 2 reps), ``batch_ab`` (1,024 queries in sub-batches of 256, 512
   and 1,024) and ``int4_ab`` (one sub-batch of 1,024), both over 32,768
   docs (kernels C2 and E2, recall@10 against the port's oracle >= 0.95);
   kernels A, C2 and E2 each launched in the tools' windows, C2 and E2 as
   often as the timed sub-batches ask.

Each path runs in its own counted window: the kernel launch counts are
zeroed just before it and read just after, and each kernel of the path
must have launched. The line before the last is a JSON object with each
kernel's launches (from its window), error and time beside its twin's and
its bound (the larger of its bytes over the memory rate and its operations
over the peak rate of their type), and for the redesigned kernels A, B,
C1, C2, D, E1, E2 and S the v1 control's median from the same run
(``prev_ms``); the v1 controls of kernels B, C1, C2 and S have records of
their own (``fused_topk_v1``, ``turbo_i8_v1``, ``turbo_i8_top2_v1``,
``dot_only_v1``, launched only beside the paths, so 0 launches in the
windows); the last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device the script exits non-zero and
prints no result.

The records of kernels A, B, D and E2 carry phase 16's launches
(``filtered_launches``), and A's its time at group 5 and the filtered
path's numbers; A's and B's carry phase 17's launches per step
(``entry_point_launches``) and phase 18's (``encoder_launches``) with
their time, twin time and bound at D = 256 (``d256``), and phase 19's
(``item12_launches``); A's carries phase 20's (``item14_launches``); A's
and B's carry phase 21's (``mesh``: launches per sub-batch, the shard
launch's time and bound, and for A the step, the filtered, rank, entry
point and live corpus records); and phase 22's (``tensor_parallel``: the
CLI search launches over the mesh-trained encoder's index, the time, twin
time and bound at D = 256, and for A the training steps' times and
profiles); A's, C2's and E2's carry phase 23's (``tools``: the launches
of each tool's window, the shapes, and for C2 and E2 the times, twin times
and bounds at the new shapes).

With ``--profile``, phases 4, 8, 9, 12 (each store) and 16 (each int8
mask) add a ``profile`` line:
``torch.profiler`` over 3 runs of the path's sub-batches gives the device
time per sub-batch, the largest kernels, the launches per sub-batch and the
device's busy share of the profiled wall time (a floor: the profiler slows
the host).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import datetime
import functools
import gc
import io
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from openintel_tpu_torch import convert, native
from openintel_tpu_torch.cli.main import main as cli_main
from openintel_tpu_torch.index.checkpoint import load_dense, load_postings, save_index
from openintel_tpu_torch.index.schema import DenseIndex
from openintel_tpu_torch.index import build as index_build
from openintel_tpu_torch.index import checkpoint as index_checkpoint
from openintel_tpu_torch.index.synthetic import (
    flip_tokens,
    synthetic_postings_index,
    synthetic_queries_from_docs,
    synthetic_synonym_corpus,
    synthetic_token_corpus,
)
from openintel_tpu_torch.mcp.server import build_server
from openintel_tpu_torch.models.reranker import rerank_search_result
from openintel_tpu_torch.models.retrievers import (
    HybridRetriever,
    SearchResult,
    auto_prune_m,
    dense_arm_topk,
    filtered_fetch_width,
    grouped_query_plan,
    make_filter_mask,
    starved_rows,
)
from openintel_tpu_torch.models import train as train_mod
from openintel_tpu_torch.models.encoder import EncoderConfig, NeuralEmbedder, info_nce_loss
from openintel_tpu_torch.models.train import load_embedder, train_encoder
from openintel_tpu_torch.models.updatable import merge_postings
from openintel_tpu_torch.ops import _kernels
from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.ops.bm25 import bm25_topk_device, build_query_plan, encode_query
from openintel_tpu_torch.ops.dense import (
    dense_topk_xla,
    dense_topk_xla_masked,
    require_true_f32,
)
from openintel_tpu_torch.ops.fusion import rrf_fuse_device
from openintel_tpu_torch.parallel import retriever as mesh_retriever
from openintel_tpu_torch.parallel import sharded
from openintel_tpu_torch.parallel import tensor as tensor_parallel
from openintel_tpu_torch.parallel.distributed import initialize_distributed
from openintel_tpu_torch.parallel.mesh import make_mesh
from openintel_tpu_torch.parallel.retriever import ShardedHybridRetriever, shard_query_plans
from openintel_tpu_torch.parallel.updatable import ShardedUpdatableHybridRetriever
from openintel_tpu_torch.serving import BatchCoalescer, PipelinedSearcher
from openintel_tpu_torch.tools import (
    arrival,
    batch_ab,
    coalescer,
    common,
    encoder_quality,
    fusion_ab,
    grouped_ab,
    int4_ab,
    kernel_decomp,
    profile_planner,
    sharded_overhead,
    topk_reduce_ab,
)

N_DOCS = 1_250_000  # bench.py's per-chip shard of the 10M-doc corpus
SMALL_DOCS = 98_304  # the largest corpus that selects kernel B (6 x 16,384 docs)
DIM = 384
VOCAB = 30_000
BATCH = 256  # queries per sub-batch
N_BATCHES = 4
K = 10
C_ARM = 32  # candidates per arm
TIE = 1e-5  # near-tie rule: ids may differ only where scores differ by at most this
ATOL = 2e-6  # kernel B scores against its twin
STEP = 2.0**-15  # kernel D: one score step (2**-16 for s + 2 in [1, 2))
RECALL_FLOOR = 0.95  # the int8 and int4 paths against the exact path
FAST_RECALL_FLOOR = 0.979  # kernel="fast": first card run (0.9992) less 0.02; PERF.md
RECALL_SLACK = 0.01  # phase 11: per-super recall may trail the grouped kernel's by this
MEASURE_NB, MEASURE_REPS, MEASURE_SAMPLE = 4, 3, 512  # phase 11's tool settings
# An H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W): device
# memory, and operations per second by operand type (int8 and bf16 on the
# tensor cores, float32 FMA outside them)
HBM_BYTES_PER_S = 3.35e12
# A yardstick beside the kernels, used nowhere in the port: one library call
# for the (B, N) product alone, written out; not the kernels' function
PRODUCT_NOTE = "product alone, not the same function:"
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
AB_ROUNDS, AB_REPS = 5, 10  # redesigned kernel vs its control: rounds x launches
WAVES = 8  # phase 14: waves of N_BATCHES sub-batches of BATCH queries
CALLERS, CALLER_QUERIES, COALESCE_S = 8, 64, 5.0  # phase 15: callers, queries a call, seconds
# phase 16's masks: at 5 % the fetch is 1,024 (group 5 at 1.25M docs) with
# ~51 expected survivors against c = 32, so the compared results come
# through the kernels; at 1 % every pool starves and the fallback serves
SELECTIVITIES = (0.5, 0.1, 0.05, 0.01)
ARM_SELECTIVITIES = (("50 %", 0.5), ("5 %", 0.05), ("1 %", 0.01))
INCLUDE_DOCS = 20  # phase 16: an include-list too small for any dense pool
FILTER_CALL_S = 2.0  # phase 16: seconds of coalesced filtered callers
MCP_CALL_S = 3.0  # phase 17: seconds of concurrent search_corpus callers


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(inputs, outputs, ops: float, kind: str) -> dict:
    """The least time the card could take for a kernel's work: each input
    read once and each output written once at the memory rate, or its
    operations at the peak rate of their type, whichever is longer."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {
        "bound_ms": max(mem_ms, ops_ms),
        "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
    }


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, limit, **extra) -> dict:
    """One kernel's record for the ``kernels`` line. No single PyTorch call
    computes any of these kernels' functions (packed top-k folds, a fused
    top-k, per-lane dot sums), so ``library_ms`` is null for each. ``extra``:
    ``prev_ms`` (the A/B control's median from the same run) and the like."""
    return {
        "name": name, "route": "cuda", "source": f"openintel_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, **limit, "library_ms": None, **extra,
    }


def product_ops(queries, corpus) -> float:
    """Multiply-adds x 2 of a (B, D) x (N, D)^T product."""
    return 2.0 * queries.shape[0] * corpus.shape[0] * queries.shape[1]


def near_tie_check(vals, ids, ref_vals, ref_ids, *, tie=TIE, atol=None) -> int:
    """Ids must equal the reference's except at ranks where the two docs'
    scores differ by at most ``tie``; each row's ids are distinct. With
    ``atol``, scores at equal ids must also agree to it. Returns the number
    of ranks whose ids differ (all within the rule)."""
    vals, ids = np.asarray(vals, np.float64), np.asarray(ids)
    ref_vals, ref_ids = np.asarray(ref_vals, np.float64), np.asarray(ref_ids)
    assert ids.shape == ref_ids.shape, (ids.shape, ref_ids.shape)
    diff = ids != ref_ids
    gap = np.abs(vals - ref_vals)
    if diff.any():
        worst = gap[diff].max()
        assert worst <= tie, f"ids differ at a score gap of {worst:.3g}"
    if atol is not None and (~diff).any():
        err = gap[~diff].max()
        assert err <= atol, f"scores differ by {err:.3g} > {atol}"
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == real.size, f"duplicate ids {row}"
    return int(diff.sum())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ab_rounds(new, old, rounds: int = AB_ROUNDS, reps: int = AB_REPS, timer=cuda_ms):
    """A/B timing in one call: ``rounds`` rounds, each timing ``reps``
    launches of the new kernel and of its control back to back (the order
    flips every round) with ``timer(fn, reps)``. Returns (new ms per round,
    control ms per round)."""
    new_ms, old_ms = [], []
    for r in range(rounds):
        pair = ((new, new_ms), (old, old_ms))
        for fn, out in pair if r % 2 == 0 else pair[::-1]:
            out.append(timer(fn, reps))
    return new_ms, old_ms


def ab_line(new_ms, old_ms, names=("new", "v1")) -> str:
    a, b = names
    rounds = ", ".join(f"{n:.4f}/{o:.4f}" for n, o in zip(new_ms, old_ms))
    wins = sum(n < o for n, o in zip(new_ms, old_ms))
    lead = "median" if a == "new" else f"{a} median"
    return (
        f"{lead} {statistics.median(new_ms):.4f} ms vs {b} {statistics.median(old_ms):.4f} ms "
        f"(rounds {a}/{b}: {rounds}; {a} faster in {wins} of {len(new_ms)})"
    )


def device_split(fn, reps: int = AB_REPS) -> dict:
    """Device milliseconds per call of each kernel ``fn`` launches, from
    ``torch.profiler`` over ``reps`` calls (for a kernel too short for CUDA
    events around back-to-back calls, which then time the host's launches)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {
        e.key: e.self_device_time_total / reps / 1e3
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total
    }


def unit_rows(rng, n, dim):
    x = rng.standard_normal((n, dim), dtype=np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


# ---------------------------------------------------------------------------
# Phase 1: environment and kernel build
# ---------------------------------------------------------------------------


def phase_environment() -> dict:
    card = card_line()
    log(card)  # name, power limit: beside every number below
    so, build_s = _kernels.build()
    _kernels.load_library()
    native.build()
    planner = native._load() is not None
    require_true_f32()
    log(
        f"phase1 env: {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | kernels built in "
        f"{build_s:.1f}s ({so.name}) | native_planner={planner}"
    )
    if not planner:
        raise RuntimeError("the C++ query planner did not build")
    return {"card": card, "build_s": build_s}


# ---------------------------------------------------------------------------
# Phase 2: kernel A against its plain twin
# ---------------------------------------------------------------------------


def phase_kernel_a() -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    # groups 1, 2, auto (3) and 5 (the filtered path's group at 1.25M docs,
    # 77 supers in groups of 5: here too the last group holds 2 supers)
    n_super = 17
    n = (n_super - 1) * T._TURBO_UNIT + 5_000  # the last super short too
    b = 45  # pads to 64 queries
    emb = torch.from_numpy(unit_rows(rng, n, DIM)).to(dev)
    corpus = convert.int8_corpus(emb)
    q8 = T.quantize_int8(torch.from_numpy(unit_rows(rng, b, DIM))).to(dev)
    # tie-heavy operands: entries in {-1, 0, 1}, so equal keys are common
    tie_corpus = T.pad_corpus_rows(
        torch.from_numpy(rng.integers(-1, 2, (n, DIM)).astype(np.int8)).to(dev)
    )
    tie_q = torch.from_numpy(rng.integers(-1, 2, (b, DIM)).astype(np.int8)).to(dev)
    cases = 0
    for crp, q in ((corpus, q8), (tie_corpus, tie_q)):
        q_pad = torch.cat([q, q.new_zeros((64 - b, DIM))])
        for group in (1, 2, T.auto_i8_group(n, C_ARM), 5):
            for block_c in (4096, 8192):
                sub = block_c // 128
                want = T.i8_top2g_cells_plain(q_pad, crp, group=group, sub=sub)
                for label, cells in (("A", T.i8_top2g_cells), ("A v1", T.i8_top2g_cells_v1)):
                    got = cells(q_pad, crp, group=group, sub=sub)
                    for g, w, name in zip(got, want, ("k1", "k2", "s1", "s2")):
                        if not torch.equal(g, w):
                            bad = int((g != w).sum())
                            raise AssertionError(
                                f"kernel {label} {name} differs in {bad} cells "
                                f"(group={group}, block_c={block_c})"
                            )
                width = 2 * (-(-n_super // group)) * 128
                for k in (C_ARM, width + 7):  # the second clamps and pads
                    kv, ki = T.dense_topk_fast_i8_grouped(
                        crp, q, k=k, block_c=block_c, n_docs=n, group=group
                    )
                    pv, pi = T.dense_topk_fast_i8_grouped(
                        crp, q, k=k, block_c=block_c, n_docs=n, group=group,
                        plain=True,
                    )
                    assert torch.equal(ki, pi) and torch.equal(kv, pv)
                    assert int(ki.max()) < n
                cases += 1
    torch.cuda.synchronize()
    log(
        f"phase2 kernel A: {cases} cases (groups 1/2/auto/5, block_c 4096/8192, "
        f"N={n}, B={b}, D={DIM}, random and tie-heavy) cells and decode "
        "bit-identical to the twin, for the TMA + wgmma kernel and the v1 control"
    )


# ---------------------------------------------------------------------------
# Phase 3: kernel B against its plain twin
# ---------------------------------------------------------------------------


def phase_kernel_b() -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    base = unit_rows(rng, 20_000, DIM)
    queries = unit_rows(rng, 37, DIM)
    dup = np.concatenate([base[:500], base[:500]])  # doc i == doc i + 500
    wide = {d: (unit_rows(rng, 9_000, d), unit_rows(rng, 37, d)) for d in (100, 1_024, 1_536)}
    checks, swaps = 0, 0
    for dtype in (torch.float32, torch.bfloat16):
        cases = [
            (base, queries, 10, True), (base, queries, 32, True),
            (base[:20], queries, 32, True),  # k > n_docs: (0.0, -1) slots
            (dup, base[:8], 10, True),  # exactly equal scores, lower id first
            (base, base[:300], 32, False),  # 64-row query tiles, a ragged last one
            # D 100 pads to 112 columns; 1,536 and 1,024 at k 1,024: past v1
            (*wide[100], 32, False), (*wide[1_536], 10, False), (*wide[1_536], 32, False),
            (*wide[1_024], 1_024, False),
        ]
        for docs, q, k, with_v1 in cases:
            d = torch.from_numpy(docs).to(dev, dtype)
            qq = torch.from_numpy(q).to(dev, dtype)
            pv, pi = T.dense_topk_pallas(d, qq, k=k, plain=True)
            kernels = [T.dense_topk_pallas] + ([T.fused_topk_v1] if with_v1 else [])
            if dtype == torch.bfloat16 and k <= T._FUSED_STREAM_MAX_K:
                # the same bf16 call on the TMA + wgmma stream
                kernels.append(lambda d, qq, k: T.fused_topk(d, qq, k, route="stream"))
            for fn in kernels:
                kv, ki = fn(d, qq, k=k)
                torch.cuda.synchronize()
                assert ki.shape == (q.shape[0], k) and ki.dtype == torch.int32
                swaps += near_tie_check(
                    kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu(), atol=ATOL
                )
                if docs is dup:
                    assert torch.equal(ki, pi), "duplicate scores: tie order"
                    assert (ki[:, 0] == torch.arange(8, device=dev)).all()
                    assert (ki[:, 1] == torch.arange(500, 508, device=dev)).all()
                if k > docs.shape[0]:
                    tail = ki[:, docs.shape[0]:]
                    assert (tail == -1).all() and (kv[:, docs.shape[0]:] == 0).all()
                checks += 1
    log(
        f"phase3 kernel B: {checks} cases (f32/bf16, v2 and its v1 control, bf16 "
        f"at k <= 32 on the ring and on the stream; k 10/32, k > n_docs, "
        f"duplicate scores, B 37/300/8, D 384, and v2 alone at D 100 (padded "
        f"to 112), 1,536 (k 10/32) and 1,024 at k 1,024) match the twin "
        f"(scores atol {ATOL}, {swaps} near-tie swaps < {TIE})"
    )


# ---------------------------------------------------------------------------
# Phase 6: kernel D against its plain twin
# ---------------------------------------------------------------------------


def dyadic_rows(rng, n, dim):
    """Unit rows rounded to multiples of 2**-6: exact in bf16, and every
    partial sum of a dot of two of them is exact in float32."""
    return (np.round(unit_rows(rng, n, dim) * 64.0) / 64.0).astype(np.float32)


def step_decode(cells: torch.Tensor) -> torch.Tensor:
    """Kernel D's cell -> its truncated score (float64)."""
    return ((cells & ~127).view(torch.float32) - 2.0).double()


def check_fast_cells(got, want, scores) -> tuple[float, int]:
    """Kernel D's cells against the twin's on non-dyadic operands: each
    score within one step; where the position differs, the twin's scores of
    the two docs (``scores``: (B, n_super, 128 pos, 128 lanes)) within one
    step. Returns (max score error, cells whose position moved)."""
    err = float((step_decode(got) - step_decode(want)).abs().max())
    assert err <= STEP, f"kernel D cell score off by {err:.3g} > {STEP:.3g}"
    b, n_super = scores.shape[:2]

    def pick(c):
        return scores.gather(2, (c & 127).long().view(b, n_super, 1, 128)).view(b, -1)

    moved = (got & 127) != (want & 127)
    gap = (pick(got) - pick(want)).abs()[moved]
    assert gap.numel() == 0 or float(gap.max()) <= STEP, float(gap.max())
    return err, int(moved.sum())


def check_fast_values(vals, ids, q, rows) -> None:
    """``dense_topk_fast``'s decode: each id's value v is the id's score s
    (float64 over the operands kernel D saw) truncated to a step, v <= s <
    v + STEP, up to the float32 sum's rounding (1e-6)."""
    cand = rows[ids.clamp(min=0).long()].double()  # (B, k, D)
    s = torch.bmm(cand, q.double()[:, :, None])[:, :, 0]
    under = (s - vals.double())[ids >= 0]
    if under.numel() and not (float(under.min()) >= -1e-6 and float(under.max()) < STEP + 1e-6):
        raise AssertionError(
            f"kernel D decode: a value is not its id's truncated score "
            f"(s - v in [{float(under.min()):.3g}, {float(under.max()):.3g}])"
        )


def phase_kernel_d() -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    n = 2 * T._TURBO_UNIT + 5_000  # 3 supers, the last one short
    b = 45  # pads to 64 queries
    cases, moved, swaps = 0, 0, 0
    for dtype in (torch.float32, torch.bfloat16):
        # dyadic operands: every sum exact, cells and decode bit-identical
        corpus = T.pad_corpus_rows(torch.from_numpy(dyadic_rows(rng, n, DIM)).to(dev, dtype))
        q = torch.from_numpy(dyadic_rows(rng, b, DIM)).to(dev, dtype)
        q_pad = torch.cat([q, q.new_zeros((64 - b, DIM))])
        want = T.fast_cells_plain(q_pad, corpus)
        for label, cells in (("D", T.fast_cells), ("D v1", T.fast_cells_v1)):
            got = cells(q_pad, corpus)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"kernel {label} cells differ on dyadic operands ({dtype}): "
                    f"{int((got != want).sum())} cells"
                )
        for k in (C_ARM, 3 * 128 + 7):  # the second clamps and pads
            kv, ki = T.dense_topk_fast(corpus, q, k=k, n_docs=n)
            pv, pi = T.dense_topk_fast(corpus, q, k=k, n_docs=n, plain=True)
            assert torch.equal(ki, pi) and torch.equal(kv, pv), (dtype, k)
            assert int(ki.max()) < n
        # random unit rows: the quantum rule
        corpus = T.pad_corpus_rows(torch.from_numpy(unit_rows(rng, n, DIM)).to(dev, dtype))
        q = torch.from_numpy(unit_rows(rng, b, DIM)).to(dev, dtype)
        q_pad = torch.cat([q, q.new_zeros((64 - b, DIM))])
        want = T.fast_cells_plain(q_pad, corpus)
        scores = (q_pad.float() @ corpus.float().T).view(64, 3, 128, 128)
        moved += check_fast_cells(T.fast_cells(q_pad, corpus), want, scores)[1]
        check_fast_cells(T.fast_cells_v1(q_pad, corpus), want, scores)
        for k in (C_ARM, 3 * 128 + 7):
            kv, ki = T.dense_topk_fast(corpus, q, k=k, n_docs=n)
            pv, pi = T.dense_topk_fast(corpus, q, k=k, n_docs=n, plain=True)
            swaps += near_tie_check(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu(), tie=STEP, atol=STEP)
            check_fast_values(kv, ki, q, corpus)
            check_fast_values(pv, pi, q, corpus)
        cases += 1
    torch.cuda.synchronize()
    log(
        f"phase6 kernel D: f32 and bf16 (bf16: TMA + wgmma; its v1 control "
        f"alike), N={n}, B={b}, D={DIM}: dyadic cells and "
        f"decode (k {C_ARM}, capacity+7) bit-identical to the twin; random rows "
        f"within one step ({STEP:.3g}), {moved} cells moved position, "
        f"{swaps} decode ranks swapped within a step"
    )


# ---------------------------------------------------------------------------
# Phase 7: kernels E1/E2 against their plain twin
# ---------------------------------------------------------------------------


def phase_kernel_e() -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    n = 2 * T._TURBO_UNIT + 5_001  # ragged: the last doc pairs with padding
    b = 45
    emb = unit_rows(rng, n, DIM)
    operands = {
        "random": (
            T.quantize_int4(torch.from_numpy(emb)),
            T.quantize_int8(torch.from_numpy(unit_rows(rng, b, DIM))),
        ),
        "tie-heavy": (  # nibbles and queries in {-1, 0, 1}
            torch.from_numpy(rng.integers(-1, 2, (n, DIM)).astype(np.int8)),
            torch.from_numpy(rng.integers(-1, 2, (b, DIM)).astype(np.int8)),
        ),
    }
    cases = 0
    for name, (e4, q8) in operands.items():
        packed = T.pack_corpus_i4(e4).to(dev)
        q8 = q8.to(dev)
        q_pad = torch.cat([q8, q8.new_zeros((64 - b, DIM))])
        for slots in (1, 2):
            want = T.i4_cells_plain(q_pad, packed, slots=slots)
            for label, cells in (("", T.i4_cells), (" v1", T.i4_cells_v1)):
                got = cells(q_pad, packed, slots=slots)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"kernel E{slots}{label} cells differ ({name}): "
                        f"{int((got != want).sum())} cells"
                    )
            for k in (256, 3 * 128 * slots + 7):
                kv, ki = T.dense_topk_fast_i4(packed, q8, k=k, n_docs=n, slots=slots)
                pv, pi = T.dense_topk_fast_i4(
                    packed, q8, k=k, n_docs=n, slots=slots, plain=True
                )
                assert torch.equal(ki, pi) and torch.equal(kv, pv), (name, slots, k)
                assert int(ki.max()) < n
            cases += 1
    torch.cuda.synchronize()
    log(
        f"phase7 kernels E1/E2: {cases} cases (slots 1/2, random and tie-heavy, "
        f"N={n}, B={b}, D={DIM}) cells and decode (k 256, capacity+7) "
        "bit-identical to the twin, for the TMA + wgmma kernels and the v1 control"
    )


# ---------------------------------------------------------------------------
# Phase 10: kernels C1/C2 and S against their plain twins
# ---------------------------------------------------------------------------


def phase_kernel_c_s() -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    n_super = 17  # phase 2's shape family: the last super short
    n = (n_super - 1) * T._TURBO_UNIT + 5_000
    b = 45  # pads to 64 queries
    emb = torch.from_numpy(unit_rows(rng, n, DIM)).to(dev)
    operands = {
        "random": (convert.int8_corpus(emb), T.quantize_int8(torch.from_numpy(unit_rows(rng, b, DIM)))),
        "tie-heavy": (  # entries in {-1, 0, 1}: equal dots are common
            torch.from_numpy(rng.integers(-1, 2, (n, DIM)).astype(np.int8)),
            torch.from_numpy(rng.integers(-1, 2, (b, DIM)).astype(np.int8)),
        ),
        "saturated": (  # every entry 127: kernel S's lane sums wrap mod 2**32
            torch.full((n, DIM), 127, dtype=torch.int8),
            torch.full((b, DIM), 127, dtype=torch.int8),
        ),
    }
    cases, wrapped = 0, 0
    for name, (crp, q) in operands.items():
        crp, q = T.pad_corpus_rows(crp.to(dev)), q.to(dev)
        q_pad = torch.cat([q, q.new_zeros((64 - b, DIM))])
        for slots in (1, 2):
            want = T.i8_turbo_cells_plain(q_pad, crp, slots=slots)
            for label, cells in (("", T.i8_turbo_cells), (" v1", T.i8_turbo_cells_v1)):
                got = cells(q_pad, crp, slots=slots)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"kernel C{slots}{label} cells differ ({name}): "
                        f"{int((got != want).sum())} cells"
                    )
            for k in (C_ARM, n_super * 128 * slots + 7):  # the second clamps and pads
                kv, ki = T.dense_topk_fast_i8(crp, q, k=k, n_docs=n, slots=slots)
                pv, pi = T.dense_topk_fast_i8(crp, q, k=k, n_docs=n, slots=slots, plain=True)
                assert torch.equal(ki, pi) and torch.equal(kv, pv), (name, slots, k)
                assert int(ki.max()) < n
            cases += 1
        got, want = T.dot_only(crp, q), T.dot_only(crp, q, plain=True)
        if not torch.equal(got, want):
            raise AssertionError(f"kernel S differs ({name}): {int((got != want).sum())} sums")
        exact = (q.double() @ crp.double().T).view(b, -1, 128).sum(dim=1)
        wrapped += int((exact != got.double()).sum())
        cases += 1
    # B=256: two query tiles (C1 in 2-block clusters, C2 unpaired); C2 also
    # with one part per super and with 16 (parts met by the merge kernel)
    crp = T.pad_corpus_rows(operands["random"][0].to(dev))
    q256 = T.quantize_int8(torch.from_numpy(unit_rows(rng, 256, DIM))).to(dev)
    for slots, max_parts in ((1, None), (2, None), (2, 1), (2, 16)):
        got = T.i8_turbo_cells(q256, crp, slots=slots, max_parts=max_parts)
        if not torch.equal(got, T.i8_turbo_cells_plain(q256, crp, slots=slots)):
            raise AssertionError(f"kernel C{slots} cells differ at B=256, max_parts={max_parts}")
        cases += 1
    torch.cuda.synchronize()
    if not wrapped:
        raise AssertionError("kernel S: no lane sum wrapped; the wrap case is not covered")
    s_cases, s_wrapped = check_kernel_s(rng)
    log(
        f"phase10 kernels C1/C2 and S: {cases} cases (slots 1/2, random, tie-heavy "
        f"and saturated, N={n}, B={b} and 256, D={DIM}) cells of the TMA + wgmma "
        f"kernels and of their v1 control, dense_topk_fast_i8 (k {C_ARM}, "
        f"capacity+7) and lane sums ({wrapped} wrapped) bit-identical to the twins; "
        f"kernel S on the stream (paired and unpaired) and v1: {s_cases} cases (random, "
        f"tie-heavy, saturated; B 45/128/256/320; D 112/384/1536; {s_wrapped} sums "
        f"wrapped) bit-identical; {wrap_probe()}"
    )


def check_kernel_s(rng) -> tuple[int, int]:
    """Kernel S on the stream (at B=256 paired and unpaired) and its v1
    control against the twin over two supers (the last short): random,
    tie-heavy and all -128 operands (the largest dots: the lane sums wrap at
    D=1536) at every query tiling and three widths (queries in registers,
    and from shared memory at 1,536). Returns (cases, sums that wrapped)."""
    dev = torch.device("cuda")
    n = T._TURBO_UNIT + 5_000
    cases = wrapped = 0
    for dim in (112, 384, 1536):
        operands = {
            "random": rng.integers(-128, 128, (n + 320, dim)).astype(np.int8),
            "tie-heavy": rng.integers(-1, 2, (n + 320, dim)).astype(np.int8),
            "saturated": np.full((n + 320, dim), -128, np.int8),
        }
        for name, rows in operands.items():
            crp = T.pad_corpus_rows(torch.from_numpy(rows[:n]).to(dev))
            for b in (45, 128, 256, 320):
                q = T._pad_query_rows(torch.from_numpy(rows[n : n + b]).to(dev), 32).contiguous()
                want = T.dot_only_plain(q, crp)
                for paired in (True, False) if b == 256 else (True,):
                    if not torch.equal(T.dot_only_cells(q, crp, paired=paired), want):
                        raise AssertionError(
                            f"kernel S differs ({name}, B={b}, D={dim}, paired={paired})"
                        )
                if not torch.equal(T.dot_only_cells_v1(q, crp), want):
                    raise AssertionError(f"kernel S v1 differs ({name}, B={b}, D={dim})")
                exact = (q.double() @ crp.double().T).view(q.shape[0], -1, 128).sum(dim=1)
                wrapped += int((exact != want.double()).sum())
                cases += 1
    return cases, wrapped


def wrap_probe() -> str:
    """Whether the tensor cores' s32 adds wrap: kernel S forced to runs of
    128 sub-blocks at D=4096 over all -128 operands, so that each
    accumulator set's run sum is 2**32 (the served runs never leave int32,
    ``dense_topk.dot_only_run``). A measurement, not a check of S."""
    dev = torch.device("cuda")
    crp = torch.full((T._TURBO_UNIT, 4096), -128, dtype=torch.int8, device=dev)
    q = torch.full((32, 4096), -128, dtype=torch.int8, device=dev)
    _, overflows = T.dot_only_runs_plain(q, crp, parts=1, run_cap=128)
    forced = T.dot_only_cells(q, crp, run_cap=128)
    same = bool(torch.equal(forced, T.dot_only_plain(q, crp)))
    return (
        f"s32 wrap probe (runs of 128 at D=4096, {overflows} set runs past int32): "
        f"{'equal to the twin: the adds wrap' if same else 'DIFFERS from the twin: the adds do not wrap'}"
    )


# ---------------------------------------------------------------------------
# Phases 4, 5, 8, 9: the paths
# ---------------------------------------------------------------------------


def build_corpus():
    """bench.py's corpus: the synthetic postings index, unit-norm embeddings
    stored as bf16 (converted by the port), and its query batch. Shared by
    the int8, fast and int4 paths."""
    t0 = time.perf_counter()
    index = synthetic_postings_index(N_DOCS, vocab_size=VOCAB, seed=0)
    index.ensure_impact_order()
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((N_DOCS, DIM), dtype=np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    dense = DenseIndex.from_embeddings(emb, dtype=torch.bfloat16)
    total = BATCH * N_BATCHES
    ranks = np.exp(
        rng.uniform(np.log(50), np.log(VOCAB - 1), size=(total, 4))
    ).astype(np.int64)
    term_ids = [list(row + 1) for row in ranks]
    targets = rng.integers(0, N_DOCS, size=total)
    q = emb[targets] + 0.6 * rng.standard_normal((total, DIM)).astype(np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    log(
        f"setup: {N_DOCS} docs (nnz {index.nnz:,}) x {DIM} bf16, "
        f"{N_BATCHES} x {BATCH} queries ({time.perf_counter() - t0:.1f}s)"
    )
    return index, dense, term_ids, q, emb


def build_path(corpus, kernel):
    """A hybrid retriever over the shared corpus on the card (``kernel``
    None: the auto-select) and its prepared query batch."""
    index, dense, term_ids, q = corpus[:4]
    t0 = time.perf_counter()
    retr = HybridRetriever(
        index, dense, kernel=kernel, device="cuda", device_batch=BATCH
    )
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prep = retr.prepare(term_ids, q, k=K, candidates_per_arm=C_ARM)
    torch.cuda.synchronize()
    log(
        f"setup {retr.kernel}: index on the card in {t1 - t0:.1f}s; prepare of "
        f"{len(term_ids)} queries (host plan, quantise, copies) "
        f"{(time.perf_counter() - t1) * 1e3:.1f} ms, plan width "
        f"{prep.plan_doc_ids.shape[2]}"
    )
    return retr, prep


def free_device() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def counted(fn):
    """Run ``fn`` between a reset and a read of the launch counts."""
    T.reset_launch_counts()
    out = fn()
    return out, T.launch_counts()


def expect_launches(counts, **want) -> None:
    """Exactly these kernels launched in the window, as many times."""
    got = {name: n for name, n in counts.items() if n}
    if got != want:
        raise AssertionError(f"launches {got}, expected {want}")


def drive(retr, prep):
    """The path through its entry points: one timed, synced run."""
    t0 = time.perf_counter()
    res = retr.finalize_prepared(prep, retr.run_prepared_device(prep))
    return res, time.perf_counter() - t0


def check_result(res, n_docs: int = N_DOCS) -> None:
    n_q = BATCH * N_BATCHES
    ids, scores = res.ids, res.scores
    assert ids.shape == (n_q, K) and scores.shape == (n_q, K)
    assert np.isfinite(scores).all()
    assert ((ids >= -1) & (ids < n_docs)).all() and (ids[:, 0] >= 0).all()


def plain_result(retr, prep):
    return retr.finalize_prepared(prep, retr.run_prepared_device(prep, plain=True))


def step_ms(retr, prep, plain: bool, reps: int) -> float:
    """Median per-sub-batch milliseconds of the hybrid step (host clock,
    device synced), over ``reps`` runs of all sub-batches."""

    def once():
        torch.cuda.synchronize()
        t = time.perf_counter()
        retr.run_prepared_device(prep, plain=plain)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / N_BATCHES

    once()  # warm
    return statistics.median(once() for _ in range(reps))


def profile_step(retr, prep, steps: int = 3) -> str:
    """``torch.profiler`` over ``steps`` runs of all sub-batches: device time
    per sub-batch, the three largest kernels, launches per sub-batch, and the
    device's busy share of the profiled wall time."""
    return profile_calls(
        lambda: retr.run_prepared_device(prep), steps, prep.queries.shape[0], "sub-batch"
    )


def profile_calls(fn, runs: int, per_run: int, unit: str) -> str:
    """``torch.profiler`` over ``runs`` calls of ``fn`` after a warm one,
    each call ``per_run`` units: device time per unit, the three largest
    kernels, launches per unit and the device's busy share of the
    profiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in dev)
    if not total_us:
        raise AssertionError("the profiler saw no device time")
    per = runs * per_run
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:3]
    tops = "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / per / 1e3:.3f} ms "
        f"({100 * e.self_device_time_total / total_us:.1f} %)"
        for e in top
    )
    return (
        f"device {total_us / per / 1e3:.3f} ms per {unit} in "
        f"{sum(e.count for e in dev) / per:.0f} launches, busy share "
        f"{total_us / wall_us:.3f}; largest: {tops}"
    )


def exact_hybrid(retr, prep, rows, q32):
    """The hybrid with the exact dense arm (blocked f32 product over the
    stored rows, f32 queries): the reference recall is measured against."""
    out = []
    c = prep.candidates_per_arm
    for i in range(prep.queries.shape[0]):
        d_vals, d_ids = dense_topk_xla(rows, q32[i], c)
        b_vals, b_ids = bm25_topk_device(
            prep.plan_doc_ids[i], prep.plan_weights[i], retr.n_docs, c,
            presorted=prep.presorted, max_run=prep.max_run,
        )
        out.append(retr._fuse_arms(b_vals, b_ids, d_vals, d_ids, prep.k)[1])
    return torch.stack(out).cpu().numpy().reshape(-1, prep.k)


def recall_at_k(got: np.ndarray, exact: np.ndarray) -> float:
    recs = []
    for g, e in zip(got, exact):
        want = {int(x) for x in e if x >= 0}
        if want:
            recs.append(len(want & {int(x) for x in g if x >= 0}) / len(want))
    return float(np.mean(recs)) if recs else 1.0


def f32_queries(corpus, prep):
    q = corpus[3]
    return torch.from_numpy(q).cuda().view(prep.queries.shape[0], BATCH, DIM)


def text_corpus():
    docs = synthetic_token_corpus(20_000, vocab_size=5_000, seed=3)
    queries = synthetic_queries_from_docs(docs, 12, seed=4) + [
        "t1 t2", "no such words here", ""
    ]
    return docs, queries


def phase_int8_path(corpus, card, profile: bool) -> dict:
    retr, prep = build_path(corpus, None)
    if retr.kernel != "int8":
        raise AssertionError(f"auto-select gave {retr.kernel}, not int8")
    (res, first_s), counts = counted(lambda: drive(retr, prep))
    expect_launches(counts, i8_top2g=N_BATCHES)
    check_result(res)
    plain = plain_result(retr, prep)
    swaps = near_tie_check(res.scores, res.ids, plain.scores, plain.ids)
    exact_equal = bool(
        np.array_equal(res.ids, plain.ids) and np.array_equal(res.scores, plain.scores)
    )
    recall = recall_at_k(
        res.ids, exact_hybrid(retr, prep, retr.dense._rescore_emb, prep.queries)
    )
    per_batch = step_ms(retr, prep, False, 15)
    plain_per_batch = step_ms(retr, prep, True, 3)
    log(
        f"phase4 main path: {BATCH * N_BATCHES} queries in {first_s:.3f}s (first "
        f"run), kernel A launches {counts['i8_top2g']}, results vs plain path: "
        f"exactly equal={exact_equal}, near-tie swaps {swaps}; recall@{K} vs "
        f"exact path {recall:.4f}; median per-batch (B={BATCH}) "
        f"{per_batch:.3f} ms with kernels, {plain_per_batch:.3f} ms with "
        f"twins [{card}]"
    )
    if recall < RECALL_FLOOR:
        raise AssertionError(f"recall@{K} {recall:.4f} < {RECALL_FLOOR}")
    if profile:
        log(f"profile int8: {profile_step(retr, prep)} [{card}]")

    # kernel A alone at the main path's shapes, against its v1 control
    q8 = prep.queries_i8[0].contiguous()
    emb = retr.dense._emb_device
    group = T.auto_i8_group(N_DOCS, C_ARM)
    sub = retr._dense_block_c(BATCH) // 128
    n_super = emb.shape[0] // T._TURBO_UNIT
    got = T.i8_top2g_cells(q8, emb, group=group, sub=sub)
    want = T.i8_top2g_cells_plain(q8, emb, group=group, sub=sub)
    v1 = T.i8_top2g_cells_v1(q8, emb, group=group, sub=sub)
    a_err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    if a_err or not all(torch.equal(g, w) for g, w in zip(v1, want)):
        raise AssertionError(f"kernel A (or v1) differs from its twin by {a_err}")
    # the second stage alone, on the twin's first stage
    steps = T.i8_step_tops_plain(q8, emb, sub=sub)
    folded = T.i8_fold_steps(steps, n_super=n_super, group=group, sub=sub)
    if not all(torch.equal(f, w) for f, w in zip(folded, want)):
        raise AssertionError("kernel A's fold stage differs from the twin")
    new_ms, old_ms = ab_rounds(
        lambda: T.i8_top2g_cells(q8, emb, group=group, sub=sub),
        lambda: T.i8_top2g_cells_v1(q8, emb, group=group, sub=sub),
    )
    split = device_split(lambda: T.i8_top2g_cells(q8, emb, group=group, sub=sub))
    stream_ms = sum(ms for name, ms in split.items() if "i8_steps_tma" in name)
    fold_ms = sum(ms for name, ms in split.items() if "i8_fold" in name)
    a_ms, a_v1_ms = statistics.median(new_ms), statistics.median(old_ms)
    a_plain_ms = cuda_ms(lambda: T.i8_top2g_cells_plain(q8, emb, group=group, sub=sub), 3)
    limit = bound((q8, emb), got, product_ops(q8, emb), "int8")
    log(
        f"kernel A at B={BATCH}, N={N_DOCS}, D={DIM}, group={group}, sub={sub}: "
        f"{ab_line(new_ms, old_ms)}; device time per call (profiler): stream "
        f"{stream_ms:.4f} ms, fold {fold_ms:.4f} ms; twin "
        f"{a_plain_ms:.3f} ms; bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}), "
        f"share {limit['bound_ms'] / a_ms:.3f} (v1 {limit['bound_ms'] / a_v1_ms:.3f}) [{card}]"
    )
    return kernel_entry(
        "i8_top2g", "i8_top2g_tma.cu", "openintel_tpu/ops/pallas/dense_topk.py:591",
        counts["i8_top2g"], a_err, a_ms, a_plain_ms, limit, prev_ms=a_v1_ms,
        stream_ms=stream_ms, fold_ms=fold_ms,
    )


def time_b_shape(label, rows, q, k, card) -> dict:
    """Kernel B v2 against its v1 control at one shape: both checked
    against the twin, then 5 alternating rounds of 10 launches each, the
    twin's time, the bound, and the two-call yardstick (a product and a
    top-k, not the same tie rule; the port never calls it)."""
    kind = "bf16" if rows.dtype == torch.bfloat16 else "f32"
    want = T.fused_topk_plain(rows, q, k)
    # bf16 at k <= 32 may also run on the stream: the same call, timed
    # against the served ring in rounds of its own
    on_stream = kind == "bf16" and k <= T._FUSED_STREAM_MAX_K
    stream = lambda: T.fused_topk(rows, q, k, route="stream")  # noqa: E731
    errs = []
    for fn in (T.fused_topk, T.fused_topk_v1):
        got = fn(rows, q, k)
        near_tie_check(*(t.cpu() for t in (*got, *want)), atol=ATOL)
        same = got[1] == want[1]
        errs.append(float((got[0] - want[0]).abs()[same].max()))
    new_ms, old_ms = ab_rounds(lambda: T.fused_topk(rows, q, k), lambda: T.fused_topk_v1(rows, q, k))
    split = device_split(lambda: T.fused_topk(rows, q, k))
    v1_split = device_split(lambda: T.fused_topk_v1(rows, q, k))
    partial_ms = sum(ms for name, ms in split.items() if "fused_topk_v2_partial" in name)
    merge_ms = sum(ms for name, ms in split.items() if "fused_topk_v2_merge" in name)
    v1_device_ms = sum(ms for name, ms in v1_split.items() if "fused_topk_" in name)
    plain_ms = cuda_ms(lambda: T.fused_topk_plain(rows, q, k), 3)
    limit = bound((q, rows), want, product_ops(q, rows), kind)
    composite = cuda_ms(lambda: torch.topk(torch.matmul(q, rows.T), k), 10)
    ms, v1_ms = statistics.median(new_ms), statistics.median(old_ms)
    ring_note, ring_fields = "", {}
    if on_stream:
        got = stream()
        near_tie_check(*(t.cpu() for t in (*got, *want)), atol=ATOL)
        st_ms, ring_ms = ab_rounds(stream, lambda: T.fused_topk(rows, q, k))
        st_split = device_split(stream)
        st_dev = sum(ms for name, ms in st_split.items() if "fused_topk_v2_" in name)
        rounds = ", ".join(f"{a:.4f}/{r:.4f}" for a, r in zip(st_ms, ring_ms))
        wins = sum(a < r for a, r in zip(st_ms, ring_ms))
        ring_note = (
            f"; stream (route='stream') vs the served ring: median "
            f"{statistics.median(st_ms):.4f} vs {statistics.median(ring_ms):.4f} ms "
            f"(rounds stream/ring: {rounds}; stream faster in {wins} of {len(st_ms)}), "
            f"stream device {st_dev:.4f} ms (tma kernel + merge)"
        )
        ring_fields = {
            "stream_ms": statistics.median(st_ms), "stream_rounds": st_ms,
            "ring_rounds": ring_ms, "stream_device_ms": st_dev,
        }
    log(
        f"kernel B shape {label}: B={q.shape[0]}, N={rows.shape[0]}, D={rows.shape[1]} "
        f"{kind}, k={k}: {ab_line(new_ms, old_ms)}; "
        f"device time per call (profiler): partial {partial_ms:.4f} ms + merge "
        f"{merge_ms:.4f} ms (v1 {v1_device_ms:.4f} ms); twin {plain_ms:.3f} ms; bound "
        f"{limit['bound_ms']:.4f} ms ({limit['bound_by']}), share "
        f"{limit['bound_ms'] / ms:.3f} (v1 {limit['bound_ms'] / v1_ms:.3f}); two "
        f"calls, not the same tie rule: torch.topk(torch.matmul) {composite:.4f} ms"
        f"{ring_note} [{card}]"
    )
    return {
        "ms": ms, "v1_ms": v1_ms, "rounds": new_ms, "v1_rounds": old_ms,
        "plain_ms": plain_ms, "composite_ms": composite, "err": errs[0],
        "partial_ms": partial_ms, "merge_ms": merge_ms, "v1_device_ms": v1_device_ms,
        "v1_err": errs[1], **ring_fields, **limit,
    }


def phase_text(card) -> dict:
    docs, text_queries = text_corpus()

    def serve():
        retr = HybridRetriever.build(docs, device="cuda")
        return retr, retr.search(text_queries, k=K)

    (text_retr, text_res), counts = counted(serve)
    assert text_retr.kernel == "pallas", text_retr.kernel
    assert counts["fused_topk"] >= 1 and sum(counts.values()) == counts["fused_topk"], counts
    assert text_res.ids.shape == (len(text_queries), K)
    prep5 = text_retr.prepare(
        [encode_query(text_retr.bm25.index, s) for s in text_queries],
        text_retr.dense.embedder(text_queries), k=K,
    )
    plain5 = plain_result(text_retr, prep5)
    swaps5 = near_tie_check(text_res.scores, text_res.ids, plain5.scores, plain5.ids)
    log(
        f"phase5 text: {len(docs)} docs, {len(text_queries)} queries, kernel "
        f"B launches {counts['fused_topk']}, results vs plain path near-tie swaps "
        f"{swaps5} [{card}]"
    )
    # shape a: the text path's own call
    return time_b_shape("a", text_retr.dense._emb_device, prep5.queries[0], K, card)


def small_corpus(corpus):
    """The small-corpus path's corpus: phase 4's embeddings and generator
    settings cut to SMALL_DOCS rows, its own postings index of that size,
    and N_BATCHES x BATCH queries near its docs."""
    _, _, term_ids, _, emb = corpus
    t0 = time.perf_counter()
    index = synthetic_postings_index(SMALL_DOCS, vocab_size=VOCAB, seed=0)
    index.ensure_impact_order()
    rng = np.random.default_rng(2)
    rows = emb[:SMALL_DOCS]
    targets = rng.integers(0, SMALL_DOCS, size=len(term_ids))
    q = rows[targets] + 0.6 * rng.standard_normal((len(term_ids), DIM)).astype(np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    log(f"setup small corpus: {SMALL_DOCS} docs (nnz {index.nnz:,}) x {DIM} ({time.perf_counter() - t0:.1f}s)")
    return index, rows, term_ids, q


def phase_small_path(corpus, card, profile: bool) -> tuple[dict, dict]:
    """The small-corpus hybrid path: SMALL_DOCS docs stored as bf16 and as
    f32, the auto-selected kernel B arm, 4 sub-batches of 256. Returns the
    shapes b, c-f32 and c-bf16 timed against v1, and each store's counts."""
    index, emb, term_ids, q = small_corpus(corpus)
    shapes, windows = {}, {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        dense = DenseIndex.from_embeddings(emb, dtype=dtype)
        retr, prep = build_path((index, dense, term_ids, q, None), None)
        if retr.kernel != "pallas":
            raise AssertionError(f"auto-select gave {retr.kernel}, not pallas")
        (res, first_s), counts = counted(lambda: drive(retr, prep))
        expect_launches(counts, fused_topk=N_BATCHES)
        windows[name] = counts
        check_result(res, SMALL_DOCS)
        plain = plain_result(retr, prep)
        swaps = near_tie_check(res.scores, res.ids, plain.scores, plain.ids)
        rows = retr.dense._emb_device
        q32 = torch.from_numpy(q).cuda().view(N_BATCHES, BATCH, DIM)
        # the exact dense arm on the served queries (the store's dtype):
        # equal up to near-ties; on f32 queries (phase 4's protocol): recall
        ev, ei = exact_scores(retr, prep, rows, prep.queries)
        near = near_tie_check(res.scores, res.ids, ev, ei)
        recall = recall_at_k(res.ids, ei)
        recall_f32q = recall_at_k(res.ids, exact_hybrid(retr, prep, rows, q32))
        per_batch = step_ms(retr, prep, False, 15)
        plain_per_batch = step_ms(retr, prep, True, 3)
        log(
            f"phase12 small-corpus path ({name} store): {BATCH * N_BATCHES} queries in "
            f"{first_s:.3f}s (first run), kernel B launches {counts['fused_topk']} "
            f"(v1 {counts['fused_topk_v1']}), results vs plain path near-tie swaps "
            f"{swaps}; recall@{K} vs exact path {recall:.4f} ({near} ranks differ, "
            f"each a near-tie; {recall_f32q:.4f} against f32 queries); median "
            f"per-batch (B={BATCH}) {per_batch:.3f} ms with "
            f"kernels, {plain_per_batch:.3f} ms with twins [{card}]"
        )
        if profile:
            log(f"profile small {name}: {profile_step(retr, prep)} [{card}]")
        qd = prep.queries[0].contiguous()
        if name == "f32":
            shapes["b"] = time_b_shape("b", rows[:20_000], qd, C_ARM, card)
        shapes[f"c_{name}"] = time_b_shape(f"c-{name}", rows, qd, C_ARM, card)
        del retr, prep, dense
        free_device()
    return shapes, windows


def exact_scores(retr, prep, rows, q32, mask=None):
    """The exact path's fused (scores, ids), for the near-tie rule; with
    ``mask`` (an (n_docs,) bool tensor), the exact filtered hybrid: the
    masked exact dense arm and ``prep``'s mask-aware plan."""
    out_v, out_i = [], []
    c = prep.candidates_per_arm
    for i in range(prep.queries.shape[0]):
        if mask is None:
            d_vals, d_ids = dense_topk_xla(rows, q32[i], c)
        else:
            d_vals, d_ids = dense_topk_xla_masked(rows, q32[i], mask, c)
        b_vals, b_ids = bm25_topk_device(
            prep.plan_doc_ids[i], prep.plan_weights[i], retr.n_docs, c,
            presorted=prep.presorted, max_run=prep.max_run,
        )
        v, ids = retr._fuse_arms(b_vals, b_ids, d_vals, d_ids, prep.k)
        out_v.append(v)
        out_i.append(ids)
    return (
        torch.stack(out_v).cpu().numpy().reshape(-1, prep.k),
        torch.stack(out_i).cpu().numpy().reshape(-1, prep.k),
    )


def b_entries(shapes, windows) -> list:
    """The ``kernels`` records of kernel B v2 and its v1 control: the
    numbers at shape c-f32 (the served sub-batch on the largest corpus that
    selects kernel B), every shape under ``shapes``; launches from the
    small-corpus path's window (bf16 store; the f32 store's alike)."""
    c = shapes["c_f32"]
    per_shape = {
        label: {
            key: sh[key]
            for key in ("ms", "v1_ms", "plain_ms", "bound_ms", "bound_by", "composite_ms",
                        "partial_ms", "merge_ms", "v1_device_ms", "stream_ms", "stream_device_ms")
            if key in sh
        }
        for label, sh in shapes.items()
    }
    limit = {"bound_ms": c["bound_ms"], "bound_by": c["bound_by"]}
    replaces = "openintel_tpu/ops/pallas/dense_topk.py:62"
    return [
        kernel_entry(
            "fused_topk", "fused_topk_v2.cu", replaces, windows["bf16"]["fused_topk"],
            c["err"], c["ms"], c["plain_ms"], limit, prev_ms=c["v1_ms"], shapes=per_shape,
            launches_f32_store=windows["f32"]["fused_topk"],
        ),
        kernel_entry(
            "fused_topk_v1", "fused_topk.cu", replaces, windows["bf16"]["fused_topk_v1"],
            c["v1_err"], c["v1_ms"], c["plain_ms"], limit,
        ),
    ]


def phase_misfit_width(card) -> None:
    """F1 on the card: every arm serves D = 100 (padded to 112 columns at
    load, queries per call), equal to its plain-twin path on dyadic rows
    (every sum exact)."""
    rng = np.random.default_rng(12)
    n, dim = 40_000, 100
    index = synthetic_postings_index(n, vocab_size=2_000, seed=5)
    emb = dyadic_rows(rng, n, dim)
    q = dyadic_rows(rng, 70, dim)
    term_ids = [list(rng.integers(20, 2_000, size=3)) for _ in range(70)]
    arms = {"int8": "i8_top2g", "fast": "turbo_f32", "int4": "turbo_i4_top2", "pallas": "fused_topk"}
    for kernel, counter in arms.items():
        dense = DenseIndex.from_embeddings(emb, dtype=torch.bfloat16)
        retr = HybridRetriever(index, dense, kernel=kernel, device="cuda", device_batch=32)
        prep = retr.prepare(term_ids, q, k=K, candidates_per_arm=C_ARM)
        (res, _), counts = counted(lambda: drive(retr, prep))
        expect_launches(counts, **{counter: prep.queries.shape[0]})
        plain = plain_result(retr, prep)
        if not (np.array_equal(res.ids, plain.ids) and np.array_equal(res.scores, plain.scores)):
            raise AssertionError(f"D={dim}: the {kernel} path differs from its plain path")
        assert retr.dense._emb_device.shape[1] == T.padded_dim(dim)
    # kernel S through its op: the features padded per call
    e8 = T.quantize_int8(torch.from_numpy(emb)).cuda()
    q8 = T.quantize_int8(torch.from_numpy(q)).cuda()
    got, counts = counted(lambda: T.dot_only(e8, q8))
    expect_launches(counts, dot_only=1)
    if not torch.equal(got, T.dot_only(e8, q8, plain=True)):
        raise AssertionError(f"D={dim}: kernel S differs from its twin")
    log(
        f"phase13 misfit width: D={dim} (padded to {T.padded_dim(dim)}), N={n}, 70 "
        f"queries: the int8, fast, int4 and pallas paths equal their plain paths, "
        f"and dot_only (kernel S) its twin [{card}]"
    )


def dense_arms(retr, prep, plain: bool, keep=None):
    """Each sub-batch's dense arm, as ``run_prepared_device`` runs it (for
    a filtered batch its over-fetched pool, before the compaction); with
    ``keep``, that many of the rescored candidates (int4: its whole fetch)."""
    dense = retr.dense
    width = prep.c_fetch or prep.candidates_per_arm
    return [
        dense_arm_topk(
            dense.kernel, dense._emb_device, prep.queries[i], keep or width,
            n_docs=retr.n_docs, block_c=retr._dense_block_c(BATCH),
            candidates=width, rescore_op=dense._rescore_emb,
            q8=prep.queries_i8[i], plain=plain,
        )
        for i in range(prep.queries.shape[0])
    ]


def phase_fast_path(corpus, card, profile: bool) -> dict:
    retr, prep = build_path(corpus, "fast")
    (res, first_s), counts = counted(lambda: drive(retr, prep))
    expect_launches(counts, turbo_f32=N_BATCHES)
    check_result(res)
    plain = plain_result(retr, prep)
    # the dense arms within one score step; the fused results equal
    # wherever a query's dense arm is equal
    arm_swaps, same = 0, []
    arms = zip(dense_arms(retr, prep, False), dense_arms(retr, prep, True))
    for i, ((kv, ki), (pv, pi)) in enumerate(arms):
        check_fast_values(kv, ki, prep.queries[i], retr.dense._emb_device)
        kv, ki, pv, pi = (t.cpu() for t in (kv, ki, pv, pi))
        arm_swaps += near_tie_check(kv, ki, pv, pi, tie=STEP, atol=STEP)
        same.append(((ki == pi) & (kv == pv)).all(dim=1).numpy())
    same = np.concatenate(same)
    assert np.array_equal(res.ids[same], plain.ids[same])
    assert np.array_equal(res.scores[same], plain.scores[same])
    rows = retr.dense._emb_device[:N_DOCS]  # the stored rows, before the padding
    recall = recall_at_k(res.ids, exact_hybrid(retr, prep, rows, f32_queries(corpus, prep)))
    per_batch = step_ms(retr, prep, False, 15)
    plain_per_batch = step_ms(retr, prep, True, 3)
    log(
        f"phase8 fast path: {BATCH * N_BATCHES} queries in {first_s:.3f}s (first "
        f"run), kernel D launches {counts['turbo_f32']}, dense arms vs plain path "
        f"within one step ({arm_swaps} ranks swapped), results equal on "
        f"{int(same.sum())} queries whose dense arms are equal and differ on "
        f"{int((res.ids != plain.ids).any(axis=1).sum())}; recall@{K} vs exact "
        f"path {recall:.4f}; median per-batch (B={BATCH}) {per_batch:.3f} ms with "
        f"kernels, {plain_per_batch:.3f} ms with twins [{card}]"
    )
    if recall < FAST_RECALL_FLOOR:
        raise AssertionError(f"fast recall@{K} {recall:.4f} < {FAST_RECALL_FLOOR}")
    if profile:
        log(f"profile fast: {profile_step(retr, prep)} [{card}]")

    # kernel D alone at the main path's shapes, against its v1 control
    q = prep.queries[0].contiguous()
    emb = retr.dense._emb_device
    got, want = T.fast_cells(q, emb), T.fast_cells_plain(q, emb)
    d_err = float((step_decode(got) - step_decode(want)).abs().max())
    v1_err = float((step_decode(T.fast_cells_v1(q, emb)) - step_decode(want)).abs().max())
    if max(d_err, v1_err) > STEP:
        raise AssertionError(f"kernel D (v1) differs from its twin by {d_err:.3g} ({v1_err:.3g})")
    new_ms, old_ms = ab_rounds(lambda: T.fast_cells(q, emb), lambda: T.fast_cells_v1(q, emb))
    d_ms, d_v1_ms = statistics.median(new_ms), statistics.median(old_ms)
    d_plain_ms = cuda_ms(lambda: T.fast_cells_plain(q, emb), 3)
    limit = bound((q, emb), (got,), product_ops(q, emb), "bf16")
    product = cuda_ms(lambda: torch.matmul(q, emb.T), 10)
    log(
        f"kernel D at B={BATCH}, N={N_DOCS}, D={DIM} bf16: {ab_line(new_ms, old_ms)}; "
        f"twin {d_plain_ms:.3f} ms, max cell score error {d_err:.3g}, bound "
        f"{limit['bound_ms']:.4f} ms ({limit['bound_by']}), share "
        f"{limit['bound_ms'] / d_ms:.3f} (v1 {limit['bound_ms'] / d_v1_ms:.3f}); "
        f"{PRODUCT_NOTE} torch.matmul {product:.3f} ms [{card}]"
    )
    return kernel_entry(
        "turbo_f32", "turbo_bf16_tma.cu", "openintel_tpu/ops/pallas/dense_topk.py:290",
        counts["turbo_f32"], d_err, d_ms, d_plain_ms, limit, prev_ms=d_v1_ms,
    )


def phase_int4_path(corpus, card, profile: bool) -> list:
    retr, prep = build_path(corpus, "int4")
    (res, first_s), counts = counted(lambda: drive(retr, prep))
    expect_launches(counts, turbo_i4_top2=N_BATCHES)
    check_result(res)
    plain = plain_result(retr, prep)
    if not (np.array_equal(res.ids, plain.ids) and np.array_equal(res.scores, plain.scores)):
        raise AssertionError("the int4 path differs from its plain-twin path")
    recall = recall_at_k(
        res.ids, exact_hybrid(retr, prep, retr.dense._rescore_emb, prep.queries)
    )
    per_batch = step_ms(retr, prep, False, 15)
    plain_per_batch = step_ms(retr, prep, True, 3)
    log(
        f"phase9 int4 path: {BATCH * N_BATCHES} queries in {first_s:.3f}s (first "
        f"run), kernel E2 launches {counts['turbo_i4_top2']}, results equal to the "
        f"plain path; recall@{K} vs exact path {recall:.4f}; median per-batch "
        f"(B={BATCH}) {per_batch:.3f} ms with kernels, {plain_per_batch:.3f} ms "
        f"with twins [{card}]"
    )
    if recall < RECALL_FLOOR:
        raise AssertionError(f"int4 recall@{K} {recall:.4f} < {RECALL_FLOOR}")
    if profile:
        log(f"profile int4: {profile_step(retr, prep)} [{card}]")

    # the public op with slots=1 (kernel E1), as a caller would use it
    q8 = prep.queries_i8[0]
    emb = retr.dense._emb_device
    cw = max(4 * C_ARM, 256)

    def e1_op(plain=False):
        return T.dense_topk_fast_i4(
            emb, q8, k=cw, block_c=4096, n_docs=N_DOCS, slots=1, plain=plain
        )

    (e1v, e1i), e1_counts = counted(e1_op)
    expect_launches(e1_counts, turbo_i4=1)
    pv, pi = e1_op(plain=True)
    assert torch.equal(e1i, pi) and torch.equal(e1v, pv), "E1 op differs from its twin"

    # E2 and E1 alone at the main path's shapes, against their v1 control
    q8 = q8.contiguous()
    out = []
    for slots, name, line in ((2, "turbo_i4_top2", 1049), (1, "turbo_i4", 1019)):
        got = T.i4_cells(q8, emb, slots=slots)
        want = T.i4_cells_plain(q8, emb, slots=slots)
        err = int((got.long() - want.long()).abs().max())
        if err or not torch.equal(T.i4_cells_v1(q8, emb, slots=slots), want):
            raise AssertionError(f"kernel E{slots} (or v1) differs from its twin by {err}")
        new_ms, old_ms = ab_rounds(
            lambda: T.i4_cells(q8, emb, slots=slots),
            lambda: T.i4_cells_v1(q8, emb, slots=slots),
        )
        ms, v1_ms = statistics.median(new_ms), statistics.median(old_ms)
        plain_ms = cuda_ms(lambda: T.i4_cells_plain(q8, emb, slots=slots), 3)
        ops = 2.0 * q8.shape[0] * 2 * emb.shape[0] * DIM  # two docs per byte row
        limit = bound((q8, emb), (got,), ops, "int8")
        extra = {}
        if slots == 2:  # the stream kernel and, with parts, the merge of parts
            split = device_split(lambda: T.i4_cells(q8, emb, slots=2))
            extra = {
                "stream_ms": sum(v for k, v in split.items() if "turbo_i4_tma" in k),
                "merge_ms": sum(v for k, v in split.items() if "merge_top2" in k),
            }
        log(
            f"kernel E{slots} at B={BATCH}, N={N_DOCS}, D={DIM}: {ab_line(new_ms, old_ms)}; "
            + "".join(f"{k} {v:.4f} ms (profiler); " for k, v in extra.items())
            + f"twin {plain_ms:.3f} ms; bound {limit['bound_ms']:.4f} ms "
            f"({limit['bound_by']}), share {limit['bound_ms'] / ms:.3f} (v1 "
            f"{limit['bound_ms'] / v1_ms:.3f}) [{card}]"
        )
        out.append(kernel_entry(
            name, "turbo_i4_tma.cu", f"openintel_tpu/ops/pallas/dense_topk.py:{line}",
            (counts if slots == 2 else e1_counts)[name], err, ms, plain_ms, limit,
            prev_ms=v1_ms, **extra,
        ))
    log(f"phase9 E1 op: dense_topk_fast_i4(slots=1) at k={cw} equals its twin")
    return out


def phase_measurement(corpus, card) -> list:
    """Phase 11: the candidate-pass measurement tools at full width on phase
    4's corpus and queries (the stored bf16 rows, their int8 corpus), with
    kernels C1, C2, S and A in one counted window."""
    dev = torch.device("cuda")
    _, dense, _, q = corpus[:4]
    rows = convert.stored_rows(dense, dev)
    i8 = convert.int8_corpus(rows)
    qfs = torch.from_numpy(q).to(dev).view(MEASURE_NB, -1, DIM)
    q8s = T.quantize_int8(qfs)
    ref_ids = common.exact_ids(rows, qfs.view(-1, DIM)[:MEASURE_SAMPLE])
    group = T.auto_i8_group(N_DOCS, C_ARM)

    def measure():
        return (
            kernel_decomp.decompose(i8, q8s, N_DOCS, reps=MEASURE_REPS),
            topk_reduce_ab.reduce_ab(i8, rows, q8s, qfs, N_DOCS, ref_ids, reps=MEASURE_REPS),
            grouped_ab.grouped_ab(
                i8, rows, q8s, qfs, N_DOCS, ref_ids, groups=[group], reps=MEASURE_REPS
            ),
        )

    t0 = time.perf_counter()
    (decomp, reduce, grouped), counts = counted(measure)
    runs = (MEASURE_REPS + 1) * MEASURE_NB  # each row: a warm-up rep, then the reps
    n_reducers = len(topk_reduce_ab.reducers(i8.shape[0] // T._TURBO_UNIT))
    expect_launches(
        counts, dot_only=runs, turbo_i8=runs,
        turbo_i8_top2=runs * (2 + n_reducers + 1), i8_top2g=runs,
    )
    log(
        f"phase11 measurement tools at N={N_DOCS}, D={DIM}, {MEASURE_NB} x {BATCH} "
        f"queries, {MEASURE_REPS} reps, recall over {MEASURE_SAMPLE} queries "
        f"({time.perf_counter() - t0:.1f}s); {common.clock_note(dev, MEASURE_REPS, MEASURE_NB)} [{card}]"
    )
    for name, rows_ in (("kernel_decomp", decomp), ("topk_reduce_ab", reduce), ("grouped_ab", grouped)):
        for row in rows_:
            log(f"  {name}: {common.row_line(row)}")

    # one sub-batch: the op against its plain path, no id past the corpus
    q8 = q8s[0]
    for slots in (1, 2):
        kv, ki = T.dense_topk_fast_i8(i8, q8, k=C_ARM, n_docs=N_DOCS, slots=slots)
        pv, pi = T.dense_topk_fast_i8(i8, q8, k=C_ARM, n_docs=N_DOCS, slots=slots, plain=True)
        if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
            raise AssertionError(f"dense_topk_fast_i8(slots={slots}) differs from its plain path")
        if int(ki.max()) >= N_DOCS:
            raise AssertionError(f"dense_topk_fast_i8(slots={slots}) leaked a padding id")
    per_super = next(r["recall"] for r in grouped if r["group"] == 0)
    grouped_a = next(r["recall"] for r in grouped if r["group"] == group)
    log(
        f"phase11 checks: dense_topk_fast_i8 slots 1/2 equal to the plain path, "
        f"ids < n_docs; recall@{K} after rescore per-super slots=2 {per_super:.4f}, "
        f"grouped kernel A g={group} {grouped_a:.4f}"
    )
    if per_super < grouped_a - RECALL_SLACK:
        raise AssertionError(
            f"per-super recall {per_super:.4f} < grouped {grouped_a:.4f} - {RECALL_SLACK}"
        )

    # kernels C2, C1 and S alone at the main shapes
    product = cuda_ms(lambda: torch._int_mm(q8, i8.t()), 10)
    log(
        f"kernels A, C1, C2, S (and E's int8 equivalent) at B={BATCH}, "
        f"N={N_DOCS}, D={DIM} int8: {PRODUCT_NOTE} torch._int_mm "
        f"{product:.3f} ms [{card}]"
    )
    out = []
    line = "openintel_tpu/ops/pallas/dense_topk.py"
    for name, slots, at in (("turbo_i8_top2", 2, 535), ("turbo_i8", 1, 507)):
        got = T.i8_turbo_cells(q8, i8, slots=slots)
        want = T.i8_turbo_cells_plain(q8, i8, slots=slots)
        v1 = T.i8_turbo_cells_v1(q8, i8, slots=slots)
        err = int((got.long() - want.long()).abs().max())
        v1_err = int((v1.long() - want.long()).abs().max())
        if err or v1_err:
            raise AssertionError(f"kernel C{slots} (or v1) differs from its twin by {max(err, v1_err)}")
        new_ms, old_ms = ab_rounds(
            lambda: T.i8_turbo_cells(q8, i8, slots=slots),
            lambda: T.i8_turbo_cells_v1(q8, i8, slots=slots),
        )
        ms, v1_ms = statistics.median(new_ms), statistics.median(old_ms)
        plain_ms = cuda_ms(lambda: T.i8_turbo_cells_plain(q8, i8, slots=slots), 3)
        limit = bound((q8, i8), (got,), product_ops(q8, i8), "int8")
        log(
            f"kernel C{slots} at B={BATCH}, N={N_DOCS}, D={DIM}: {ab_line(new_ms, old_ms)}; "
            f"twin {plain_ms:.3f} ms; bound {limit['bound_ms']:.4f} ms "
            f"({limit['bound_by']}), share {limit['bound_ms'] / ms:.3f} (v1 "
            f"{limit['bound_ms'] / v1_ms:.3f}) [{card}]"
        )
        source, replaces = "turbo_i8_tma.cu", f"{line}:{at}"
        out.append(kernel_entry(
            name, source, replaces, counts[name], err, ms, plain_ms, limit, prev_ms=v1_ms,
        ))
        out.append(kernel_entry(
            f"{name}_v1", "turbo_i8.cu", replaces, counts[f"{name}_v1"], v1_err, v1_ms,
            plain_ms, limit,
        ))
    got, want = T.dot_only_cells(q8, i8), T.dot_only_plain(q8, i8)
    v1 = T.dot_only_cells_v1(q8, i8)
    err = int((got.long() - want.long()).abs().max())
    v1_err = int((v1.long() - want.long()).abs().max())
    if err or v1_err:
        raise AssertionError(f"kernel S (or v1) differs from its twin by {max(err, v1_err)}")

    def two_calls():  # the product, then the per-lane sum, wrapped
        return T._wrap_int32(torch._int_mm(q8, i8.t()).view(BATCH, -1, 128).sum(dim=1))

    if not torch.equal(two_calls(), want):
        raise AssertionError("the two-call yardstick differs from kernel S's twin")
    new_ms, old_ms = ab_rounds(lambda: T.dot_only_cells(q8, i8), lambda: T.dot_only_cells_v1(q8, i8))
    pair_ms, solo_ms = ab_rounds(
        lambda: T.dot_only_cells(q8, i8, paired=True),
        lambda: T.dot_only_cells(q8, i8, paired=False),
    )
    two_ms = statistics.median(cuda_ms(two_calls, AB_REPS) for _ in range(AB_ROUNDS))
    ms, v1_ms = statistics.median(new_ms), statistics.median(old_ms)
    plain_ms = cuda_ms(lambda: T.dot_only_plain(q8, i8), 3)
    limit = bound((q8, i8), (got,), product_ops(q8, i8), "int8")
    log(
        f"kernel S at B={BATCH}, N={N_DOCS}, D={DIM}: {ab_line(new_ms, old_ms)}; "
        f"{ab_line(pair_ms, solo_ms, ('paired', 'unpaired'))}; served "
        f"{'paired' if T._S_PAIRED else 'unpaired'}; twin {plain_ms:.3f} ms; two calls, "
        f"not one library call: torch._int_mm then the per-lane sum {two_ms:.4f} ms; "
        f"bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}), share "
        f"{limit['bound_ms'] / ms:.3f} (v1 {limit['bound_ms'] / v1_ms:.3f}) [{card}]"
    )
    replaces = "scripts/bench_kernel_decomp.py:99"
    out.append(kernel_entry(
        "dot_only", "dot_only_tma.cu", replaces, counts["dot_only"], err, ms, plain_ms, limit,
        prev_ms=v1_ms, paired_ms=statistics.median(pair_ms),
        unpaired_ms=statistics.median(solo_ms), two_call_ms=two_ms,
    ))
    out.append(kernel_entry(
        "dot_only_v1", "dot_only.cu", replaces, counts["dot_only_v1"], v1_err, v1_ms, plain_ms,
        limit,
    ))
    return out


# ---------------------------------------------------------------------------
# Phases 14, 15: serving (openintel_tpu_torch.serving)
# ---------------------------------------------------------------------------


def term_ranks(rng, n):
    """Phase 4's query terms: 4 ranks a query, log-uniform over the vocabulary."""
    return np.exp(rng.uniform(np.log(50), np.log(VOCAB - 1), size=(n, 4))).astype(np.int64)


def wave(emb, rng, n):
    """A wave by phase 4's generator: term ids and embeddings near random docs."""
    term_ids = [list(row + 1) for row in term_ranks(rng, n)]
    targets = rng.integers(0, N_DOCS, size=n)
    q = emb[targets] + 0.6 * rng.standard_normal((n, DIM)).astype(np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    return term_ids, q


def ms_median(seconds) -> float:
    return statistics.median(seconds) * 1e3


def phase_pipelined(corpus, card) -> HybridRetriever:
    """Phase 14: ``PipelinedSearcher(depth=2)`` over phase 4's retriever
    (the int8 arm) against the sequential loop, on WAVES waves of
    N_BATCHES x BATCH queries, in turns (sequential, pipelined, pipelined,
    sequential). Returns the retriever for phase 15."""
    index, dense, _, _, emb = corpus
    retr = HybridRetriever(index, dense, device="cuda", device_batch=BATCH)
    if retr.kernel != "int8":
        raise AssertionError(f"auto-select gave {retr.kernel}, not int8")
    rng = np.random.default_rng(21)
    waves = [wave(emb, rng, N_BATCHES * BATCH) for _ in range(WAVES)]
    n_q = WAVES * N_BATCHES * BATCH
    kw = {"k": K, "candidates_per_arm": C_ARM}
    retr.run_prepared(retr.prepare(*wave(emb, rng, N_BATCHES * BATCH), **kw))  # warm

    def sequential():
        """Each stage to its end in turn: prepare (staging synced), the
        step's dispatch, the wait for its result."""
        stages = {"prepare": [], "dispatch": [], "step": []}
        out = []
        t0 = time.perf_counter()
        for w in waves:
            t = time.perf_counter()
            prep = retr.prepare(*w, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            copy = retr.copy_back(retr.run_prepared_device(prep))
            t2 = time.perf_counter()
            out.append(retr.finalize_prepared(prep, copy))
            stages["prepare"].append(t1 - t)
            stages["dispatch"].append(t2 - t1)
            stages["step"].append(time.perf_counter() - t1)
        return out, time.perf_counter() - t0, stages

    pipe = PipelinedSearcher(retr, depth=2)

    def pipelined():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = list(pipe.run_prepared_stream(iter(waves), **kw))
        return out, time.perf_counter() - t0, {k: list(v) for k, v in pipe.stage_seconds.items()}

    want, seq1, alone = sequential()
    (got, pipe1, inside), counts = counted(pipelined)
    expect_launches(counts, i8_top2g=WAVES * N_BATCHES)
    _, pipe2, inside2 = pipelined()
    _, seq2, alone2 = sequential()
    for i, (g, w) in enumerate(zip(got, want)):
        if not (np.array_equal(g.ids, w.ids) and np.array_equal(g.scores, w.scores)):
            raise AssertionError(f"pipelined wave {i} differs from run_prepared(prepare(wave))")
    shaped = all(g.ids.shape == (N_BATCHES * BATCH, K) for g in got)
    if not shaped or not all(np.isfinite(g.scores).all() for g in got):
        raise AssertionError("pipelined results of the wrong shape or not finite")
    seq_qps = n_q / statistics.median([seq1, seq2])
    pipe_qps = n_q / statistics.median([pipe1, pipe2])
    both = {k: alone[k] + alone2[k] for k in alone}
    both_in = {k: inside[k] + inside2[k] for k in inside}
    log(
        f"phase14 pipelined serving at N={N_DOCS}, D={DIM} (int8 arm), {WAVES} waves of "
        f"{N_BATCHES} x {BATCH} queries, depth 2: sequential {seq_qps:.0f} q/s "
        f"({seq1:.3f}/{seq2:.3f} s), pipelined {pipe_qps:.0f} q/s ({pipe1:.3f}/{pipe2:.3f} "
        f"s), ratio {pipe_qps / seq_qps:.3f}; per wave alone: prepare "
        f"{ms_median(both['prepare']):.1f} ms, step {ms_median(both['step']):.1f} ms "
        f"(its dispatch {ms_median(both['dispatch']):.1f} ms); in the pipeline: prepare "
        f"{ms_median(both_in['prepare']):.1f} ms, dispatch "
        f"{ms_median(both_in['dispatch']):.1f} ms, finalize {ms_median(both_in['finalize']):.1f} "
        f"ms (host clock, medians of {2 * WAVES}); every wave bit-identical to "
        f"run_prepared(prepare(wave)), kernel A launches {counts['i8_top2g']} [{card}]"
    )
    return retr


def phase_coalesced(retr, card) -> None:
    """Phase 15: CALLERS concurrent callers of CALLER_QUERIES query strings
    each, for COALESCE_S seconds, through ``BatchCoalescer(retr.search,
    max_batch=BATCH, max_wait_ms=2.0)``. Each caller's first and last
    result is held to a direct ``retr.search`` of its strings at its
    wave's sub-batch width (the int8 step width, 8192 at 128 queries and
    more, is part of the result; a query's result does not depend on the
    other queries of its sub-batch), under the near-tie rule."""
    waves = []  # (queries in the wave, seconds in search, waves in flight at its start)
    width = {}  # id of a query string -> its wave's size
    lock = threading.Lock()
    running = [0]

    def search_fn(queries, k):
        with lock:
            running[0] += 1
            overlap = running[0]
        t = time.perf_counter()
        res = retr.search(queries, k=k, candidates_per_arm=C_ARM)
        with lock:
            running[0] -= 1
            waves.append((len(queries), time.perf_counter() - t, overlap))
            width.update((id(q), len(queries)) for q in queries)
        return res

    co = BatchCoalescer(search_fn, max_batch=BATCH, max_wait_ms=2.0)
    retr.search(["t1 t2"] * BATCH, k=K, candidates_per_arm=C_ARM)  # warm
    calls = [[] for _ in range(CALLERS)]  # (strings, result, seconds)
    errors = []
    start = time.perf_counter()

    def caller(c):
        rng = np.random.default_rng(200 + c)
        try:
            while time.perf_counter() - start < COALESCE_S:
                strings = [" ".join(f"t{r}" for r in row) for row in term_ranks(rng, CALLER_QUERIES)]
                t = time.perf_counter()
                res = co.search(strings, k=K)
                calls[c].append((strings, res, time.perf_counter() - t))
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(c,)) for c in range(CALLERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - start
    if errors:
        raise errors[0]
    n_calls = sum(len(c) for c in calls)
    if co.queries_run != n_calls * CALLER_QUERIES or co.oldest_inflight_s() is not None:
        raise AssertionError(f"queries_run {co.queries_run} != {n_calls} calls x {CALLER_QUERIES}")
    swaps = 0
    for c in calls:
        for strings, res, _ in (c[0], c[-1]):
            w = width[id(strings[0])]
            ref = retr.search(strings + [""] * (w - len(strings)), k=K, candidates_per_arm=C_ARM)
            swaps += near_tie_check(
                res.scores, res.ids, ref.scores[: len(strings)], ref.ids[: len(strings)], atol=0.0
            )
    lat = np.array([t for c in calls for _, _, t in c]) * 1e3
    sizes = np.array([n for n, _, _ in waves])
    wave_ms = np.array([t for _, t, _ in waves]) * 1e3
    alone = np.array([o == 1 for _, _, o in waves])
    full = sizes == BATCH

    def pcts(ms):
        return f"p50 {np.percentile(ms, 50):.1f} / p99 {np.percentile(ms, 99):.1f} ms" if ms.size else "none"

    log(
        f"phase15 coalesced serving: {CALLERS} callers x {CALLER_QUERIES} queries for "
        f"{elapsed:.2f} s: {n_calls} calls, batches_run {co.batches_run}, queries_run "
        f"{co.queries_run}, {co.queries_run / elapsed:.0f} q/s; caller latency p50 "
        f"{np.percentile(lat, 50):.1f} ms, p99 {np.percentile(lat, 99):.1f} ms, max "
        f"{lat.max():.1f} ms; waves: {int(full.sum())} full of {BATCH}, "
        f"{int((~full).sum())} flushed by the timer (mean {sizes[~full].mean() if (~full).any() else 0:.0f} "
        f"queries); search per wave {pcts(wave_ms)}, started alone ({int(alone.sum())}) "
        f"{pcts(wave_ms[alone])}, beside another wave ({int((~alone).sum())}) "
        f"{pcts(wave_ms[~alone])}; each caller's first and last result equal to a "
        f"direct search of its strings ({swaps} near-tie swaps) [{card}]"
    )


# ---------------------------------------------------------------------------
# Phase 16: filtered search
# ---------------------------------------------------------------------------


def no_masked_ids(res, mask: np.ndarray, rows=slice(None)) -> None:
    ids = res.ids[rows]
    if not mask[ids[ids >= 0]].all():
        raise AssertionError("a masked doc was returned")


def same_result(a, b) -> bool:
    return bool(np.array_equal(a.ids, b.ids) and np.array_equal(a.scores, b.scores))


def synced_ms(fn, reps: int = 1) -> float:
    """Milliseconds per call of ``fn`` on the host clock, the device synced
    before and after ``reps`` calls (a path with host work and copies)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def paired_medians(fa, fb, rounds: int) -> tuple[float, float]:
    """Median synced ms of ``fa`` and of ``fb``, timed in turns by
    ``ab_rounds`` after a warm call of each."""
    fa(), fb()
    ta, tb = ab_rounds(fa, fb, rounds=rounds, reps=1, timer=synced_ms)
    return statistics.median(ta), statistics.median(tb)


def prepare_timed(retr, term_ids, q, **kw):
    """``prepare`` and its ms per query (host plan, quantise, staging)."""
    out = []
    ms = synced_ms(
        lambda: out.append(retr.prepare(term_ids, q, k=K, candidates_per_arm=C_ARM, **kw))
    )
    return out[0], ms / len(term_ids)


def fallback_ms(retr, prep, starved) -> float:
    """Milliseconds of the exact masked fallback for ``starved`` rows, per
    distinct mask group among them."""
    if not starved.size:
        return 0.0
    n_groups = len(np.unique(prep.filter_group_host.reshape(-1)[starved]))
    return synced_ms(lambda: retr._filtered_fallback(prep, starved)) / n_groups


def filtered_int8(retr, corpus, masks, card, profile: bool) -> dict:
    """Phase 16's int8 selectivities on phase 4's queries: the filtered path
    against its plain path (bit for bit) and the exact filtered hybrid
    (recall@10), its step beside the unfiltered step, the masked
    ``prepare``, the starved rows and their fallback."""
    _, _, term_ids, q, _ = corpus
    unf = retr.prepare(term_ids, q, k=K, candidates_per_arm=C_ARM)
    rows, q32 = retr.dense._rescore_emb, f32_queries(corpus, unf)
    out = {}
    for name, mask in masks.items():
        prep, prep_ms = prepare_timed(retr, term_ids, q, filter_mask=mask)
        # ceil(c / selectivity) passes 64 when a "50 %" mask keeps a doc
        # under half: the width doubles
        if prep.c_fetch != filtered_fetch_width(C_ARM, N_DOCS, int(mask.sum())):
            raise AssertionError(f"{name}: c_fetch {prep.c_fetch}, not the rule's")
        (res, first_s), counts = counted(lambda: drive(retr, prep))
        expect_launches(counts, i8_top2g=N_BATCHES)
        check_result(res)
        if not same_result(res, plain_result(retr, prep)):
            raise AssertionError(f"{name}: the filtered int8 path differs from its plain path")
        no_masked_ids(res, mask)
        pool_rule, _ = check_pools(retr, prep, f"int8 {name}")
        mask_dev = torch.from_numpy(mask).cuda()
        recall = recall_at_k(res.ids, exact_scores(retr, prep, rows, q32, mask_dev)[1])
        starved = starved_rows(prep, retr.run_prepared_device(prep)[2].cpu().numpy())
        per_batch, unf_ms = (
            ms / N_BATCHES
            for ms in paired_medians(
                lambda: retr.run_prepared_device(prep), lambda: retr.run_prepared_device(unf), 8
            )
        )
        search_ms, unf_search_ms = paired_medians(
            lambda: drive(retr, prep), lambda: drive(retr, unf), 4
        )
        fb_ms = fallback_ms(retr, prep, starved)
        log(
            f"phase16 int8 {name} mask ({int(mask.sum())} docs): c_fetch {prep.c_fetch} "
            f"(group {T.auto_i8_group(N_DOCS, prep.c_fetch)}), kernel A launches "
            f"{counts['i8_top2g']}, {pool_rule}, results equal to the plain path, no masked "
            f"id; recall@{K} vs the "
            f"exact filtered hybrid {recall:.4f}; step per sub-batch (B={BATCH}, in turns "
            f"with the unfiltered step, medians of 8) {per_batch:.3f} ms against "
            f"{unf_ms:.3f} ms (ratio {per_batch / unf_ms:.3f}); masked prepare "
            f"{prep_ms * 1e3:.1f} us a query; {starved.size} of {prep.n_queries} rows "
            f"starved, their fallback {fb_ms:.1f} ms; whole search of {prep.n_queries} "
            f"(step, copy, fallback; medians of 4 in turns) {search_ms:.1f} ms against "
            f"{unf_search_ms:.1f} ms unfiltered (ratio {search_ms / unf_search_ms:.3f}), "
            f"first run {first_s * 1e3:.1f} ms [{card}]"
        )
        if recall < RECALL_FLOOR:
            raise AssertionError(f"filtered recall@{K} {recall:.4f} < {RECALL_FLOOR}")
        if profile:
            log(f"profile int8 {name} mask: {profile_step(retr, prep)} [{card}]")
        out[name] = {
            "c_fetch": prep.c_fetch, "launches": counts["i8_top2g"], "recall": recall,
            "step_ms": per_batch, "unfiltered_step_ms": unf_ms, "prepare_us": prep_ms * 1e3,
            "starved": int(starved.size), "fallback_ms": fb_ms, "search_ms": search_ms,
            "unfiltered_search_ms": unf_search_ms,
        }
        if prep.c_fetch == T._FUSED_MAX_K and "a_group5" not in out:
            out["a_group5"] = kernel_a_group5(retr, prep, card)
    return out


def kernel_a_group5(retr, prep, card) -> dict:
    """Kernel A at the filtered path's widest fetch (1,024 candidates,
    group 5: 16 groups, 4,096 columns) against its twin and v1, and the
    exact rescore of the 1,024 candidates, timed."""
    q8 = prep.queries_i8[0].contiguous()
    emb = retr.dense._emb_device
    group = T.auto_i8_group(N_DOCS, prep.c_fetch)
    sub = retr._dense_block_c(BATCH) // 128
    got = T.i8_top2g_cells(q8, emb, group=group, sub=sub)
    want = T.i8_top2g_cells_plain(q8, emb, group=group, sub=sub)
    if group != 5 or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"kernel A at group {group} differs from its twin")
    new_ms, old_ms = ab_rounds(
        lambda: T.i8_top2g_cells(q8, emb, group=group, sub=sub),
        lambda: T.i8_top2g_cells_v1(q8, emb, group=group, sub=sub),
    )
    _, cids = T.dense_topk_fast_i8_grouped(
        emb, prep.queries_i8[0], k=prep.c_fetch, n_docs=N_DOCS, group=group,
        block_c=retr._dense_block_c(BATCH),
    )
    rows, q32 = retr.dense._rescore_emb, prep.queries[0]
    rescore_ms = cuda_ms(lambda: T.exact_rescore(rows, q32, cids, prep.c_fetch), 10)
    gathered = cids.numel() * rows.shape[1] * rows.element_size()
    log(
        f"kernel A at group {group} (N={N_DOCS}, {2 * got[0].shape[1]} key columns, "
        f"k={prep.c_fetch}): cells bit-identical to the twin; {ab_line(new_ms, old_ms)}; "
        f"exact rescore of {cids.shape[1]} candidates a query: {rescore_ms:.3f} ms a "
        f"sub-batch, {gathered / 1e6:.1f} MB of rows gathered ({gathered / rescore_ms / 1e6:.1f} "
        f"GB/s) [{card}]"
    )
    return {
        "ms": statistics.median(new_ms), "v1_ms": statistics.median(old_ms),
        "rescore_ms": rescore_ms,
    }


def filtered_starvation(retr, corpus, masks, card) -> dict:
    """Masks too small for any pool: every real row of the include-list
    starves, the fallback serves it, and the result equals the exact
    filtered hybrid (near-tie rule)."""
    _, _, term_ids, q, _ = corpus
    rows = retr.dense._rescore_emb
    out = {}
    for name, mask in masks.items():
        prep, _ = prepare_timed(retr, term_ids, q, filter_mask=mask)
        starved = starved_rows(prep, retr.run_prepared_device(prep)[2].cpu().numpy())
        if name == "include-list" and starved.size != prep.n_queries:
            raise AssertionError(f"{name}: {starved.size} of {prep.n_queries} rows starved")
        (res, _), counts = counted(lambda: drive(retr, prep))
        expect_launches(counts, i8_top2g=N_BATCHES)
        no_masked_ids(res, mask)
        ev, ei = exact_scores(
            retr, prep, rows, f32_queries(corpus, prep), torch.from_numpy(mask).cuda()
        )
        swaps = near_tie_check(res.scores, res.ids, ev, ei)
        fb_ms = fallback_ms(retr, prep, starved)
        log(
            f"phase16 starvation, {name} ({int(mask.sum())} docs): c_fetch {prep.c_fetch}, "
            f"{starved.size} of {prep.n_queries} rows starved (survivors < min(c, unmasked)); "
            f"results equal to the exact filtered hybrid ({swaps} near-tie swaps); fallback "
            f"{fb_ms:.1f} ms per starved group [{card}]"
        )
        out[name] = {"starved": int(starved.size), "fallback_ms": fb_ms}
    return out


def filtered_groups(retr, corpus, masks, card) -> None:
    """Per-query groups: G mask rows round-robin over phase 4's queries;
    each query equals a single-mask search with its own row at the grouped
    batch's fetch width (near-tie rule)."""
    _, _, term_ids, q, _ = corpus
    groups = np.arange(len(term_ids), dtype=np.int32) % masks.shape[0]
    prep, prep_ms = prepare_timed(retr, term_ids, q, filter_mask=masks, filter_group=groups)
    if prep.c_fetch != T._FUSED_MAX_K:
        raise AssertionError(f"grouped c_fetch {prep.c_fetch}, expected {T._FUSED_MAX_K}")
    (res, first_s), counts = counted(lambda: drive(retr, prep))
    expect_launches(counts, i8_top2g=N_BATCHES)
    swaps = 0
    for g in range(masks.shape[0]):
        sel = np.flatnonzero(groups == g)
        one = retr.prepare(
            [term_ids[i] for i in sel], q[sel], k=K, candidates_per_arm=C_ARM,
            filter_mask=masks[g],
        )
        one.c_fetch = prep.c_fetch  # the grouped batch's width, sized by its most selective row
        ref = retr.run_prepared(one)
        swaps += near_tie_check(res.scores[sel], res.ids[sel], ref.scores, ref.ids, atol=TIE)
        no_masked_ids(res, masks[g], sel)
    log(
        f"phase16 per-query groups: G={masks.shape[0]} rows (unmasked "
        f"{', '.join(str(int(m.sum())) for m in masks)}) round-robin over "
        f"{len(term_ids)} queries, c_fetch {prep.c_fetch}, kernel A launches "
        f"{counts['i8_top2g']}; each query equal to a single-mask search of its own "
        f"row ({swaps} near-tie swaps); masked prepare {prep_ms * 1e3:.1f} us a query, "
        f"search {first_s * 1e3:.1f} ms [{card}]"
    )


def check_pools(retr, prep, label) -> tuple[str, np.ndarray]:
    """Each sub-batch's over-fetched dense pool, before the compaction,
    against its plain pool, so a starved query (whose result is the
    fallback's on both sides) still holds the kernel at ``c_fetch``:
    ``int8`` and ``int4`` bit for bit (int4: all of E2's wider fetch,
    rescored), ``pallas`` by phase 3's rule for kernel B, ``fast`` within
    one score step. Returns the rule's words and, per query, whether the
    pools are equal."""
    width = prep.c_fetch
    if retr.kernel == "int4":
        width = min(max(4 * width, 256), retr.n_docs)
    swaps, same = 0, []
    arms = (dense_arms(retr, prep, plain, keep=width) for plain in (False, True))
    for (kv, ki), (pv, pi) in zip(*arms):
        kv, ki, pv, pi = (t.cpu() for t in (kv, ki, pv, pi))
        if retr.kernel == "fast":
            swaps += near_tie_check(kv, ki, pv, pi, tie=STEP, atol=STEP)
        elif retr.kernel == "pallas":
            swaps += near_tie_check(kv, ki, pv, pi, atol=ATOL)
        elif not (torch.equal(kv, pv) and torch.equal(ki, pi)):
            raise AssertionError(f"{label}: the {retr.kernel} pool differs from its plain pool")
        same.append(((ki == pi) & (kv == pv)).all(dim=1).numpy())
    rule = "bit for bit" if retr.kernel in ("int8", "int4") else f"{swaps} near-tie swaps"
    what = "E2's fetches" if retr.kernel == "int4" else "pools"
    return f"{what} of {width} before the compaction equal to the plain ones ({rule})", (
        np.concatenate(same)[: prep.n_queries]
    )


def filtered_arm(retr, term_ids, q, mask, counter, card, label) -> int:
    """One filtered arm on the card against its plain path: the pools by
    ``check_pools``, then the results: ``int4`` bit for bit, ``fast`` by
    phase 8's rule (equal wherever the pools are equal), ``pallas`` by
    phase 12's near-tie rule. Returns the kernel's launches."""
    prep, _ = prepare_timed(retr, term_ids, q, filter_mask=mask)
    (res, _), counts = counted(lambda: drive(retr, prep))
    expect_launches(counts, **{counter: N_BATCHES})
    no_masked_ids(res, mask)
    plain = plain_result(retr, prep)
    pools, same = check_pools(retr, prep, label)
    if retr.kernel == "int4":
        if not same_result(res, plain):
            raise AssertionError(f"{label}: the filtered int4 path differs from its plain path")
        rule = "results equal to the plain path"
    elif retr.kernel == "fast":
        if not (
            np.array_equal(res.ids[same], plain.ids[same])
            and np.array_equal(res.scores[same], plain.scores[same])
        ):
            raise AssertionError(f"{label}: results differ where the dense pools are equal")
        rule = f"results equal on the {int(same.sum())} queries whose pools are equal"
    else:
        swaps = near_tie_check(res.scores, res.ids, plain.scores, plain.ids)
        rule = f"results: {swaps} near-tie swaps against the plain path"
    starved = starved_rows(prep, retr.run_prepared_device(prep)[2].cpu().numpy())
    log(
        f"phase16 {label}: c_fetch {prep.c_fetch}, {counter} launches {counts[counter]}, "
        f"{pools}; {rule}; no masked id; {starved.size} of {prep.n_queries} rows starved "
        f"[{card}]"
    )
    return counts[counter]


def filtered_serving(retr, corpus, masks, groups_masks, card) -> None:
    """A ``PipelinedSearcher`` stream of unfiltered, single-mask and grouped
    waves, each equal to the sequential path bit for bit."""
    emb = corpus[4]
    rng = np.random.default_rng(161)
    n = N_BATCHES * BATCH
    groups = np.arange(n, dtype=np.int32) % groups_masks.shape[0]
    filters = [
        {}, {"filter_mask": masks["50 %"]},
        {"filter_mask": groups_masks, "filter_group": groups},
        {}, {"filter_mask": masks["1 %"]},
        {"filter_mask": groups_masks, "filter_group": groups},
    ]
    stream = [(*wave(emb, rng, n), f) for f in filters]
    kw = {"k": K, "candidates_per_arm": C_ARM}
    want = [retr.run_prepared(retr.prepare(t, e, **f, **kw)) for t, e, f in stream]
    pipe = PipelinedSearcher(retr, depth=2)
    t0 = time.perf_counter()
    got, counts = counted(lambda: list(pipe.run_prepared_stream(iter(stream), **kw)))
    elapsed = time.perf_counter() - t0
    expect_launches(counts, i8_top2g=len(stream) * N_BATCHES)
    for i, (g, w) in enumerate(zip(got, want)):
        if not same_result(g, w):
            raise AssertionError(f"pipelined filtered stream: wave {i} differs from sequential")
    log(
        f"phase16 pipelined: {len(stream)} waves of {N_BATCHES} x {BATCH} (unfiltered, 50 %, "
        f"grouped G={groups_masks.shape[0]}, unfiltered, 1 %, grouped) in {elapsed:.3f} s, each "
        f"equal to the sequential path, kernel A launches {counts['i8_top2g']}; finalize "
        f"(copy wait and fallback) per wave median "
        f"{ms_median(pipe.stage_seconds['finalize']):.1f} ms [{card}]"
    )


def filtered_coalesced(retr, tenants, card) -> None:
    """CALLERS callers through ``BatchCoalescer(max_batch=BATCH)`` for
    FILTER_CALL_S seconds, the first four with two tenant masks, the rest
    unfiltered. Each caller's first and last result equals a direct search
    of its strings at its wave's width, with its wave's masks: its own
    rows in its own group, the padding rows in the wave's most selective
    group, so the fetch width is the wave's (near-tie rule)."""
    waves = {}  # id of a wave's first query string -> (queries, masks, groups)
    where = {}  # id of a query string -> (that wave's key, row)
    lock = threading.Lock()

    def search_fn(queries, k, **filters):
        res = retr.search(queries, k=k, candidates_per_arm=C_ARM, **filters)
        with lock:
            waves[id(queries[0])] = (
                queries, filters.get("filter_mask"), filters.get("filter_group")
            )
            where.update((id(s), (id(queries[0]), r)) for r, s in enumerate(queries))
        return res

    co = BatchCoalescer(search_fn, max_batch=BATCH, max_wait_ms=2.0)
    names = list(tenants) * 2 + [None] * (CALLERS - 2 * len(tenants))
    calls = [[] for _ in range(CALLERS)]
    errors = []
    start = time.perf_counter()

    def caller(c):
        rng = np.random.default_rng(300 + c)
        entry = None if names[c] is None else ((names[c],), tenants[names[c]])
        try:
            while time.perf_counter() - start < FILTER_CALL_S:
                strings = [
                    " ".join(f"t{r}" for r in row) for row in term_ranks(rng, CALLER_QUERIES)
                ]
                filters = None if entry is None else [entry] * len(strings)
                res = co.search(strings, k=K, filters=filters)
                calls[c].append((strings, res))
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(c,)) for c in range(CALLERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    swaps, mixed = 0, 0
    for c, made in enumerate(calls):
        for strings, res in (made[0], made[-1]):
            key, row = where[id(strings[0])]
            queries, masks, groups = waves[key]
            pad = [""] * (len(queries) - len(strings))
            if masks is None:
                ref = retr.search(strings + pad, k=K, candidates_per_arm=C_ARM)
            else:
                mixed += 1
                present = np.unique(groups)
                tightest = present[np.argmin(masks[present].sum(axis=1))]
                own = groups[row : row + len(strings)]
                ref = retr.search(
                    strings + pad, k=K, candidates_per_arm=C_ARM, filter_mask=masks,
                    filter_group=np.concatenate([own, np.full(len(pad), tightest, np.int32)]),
                )
            n = len(strings)
            swaps += near_tie_check(res.scores, res.ids, ref.scores[:n], ref.ids[:n], atol=TIE)
            if names[c] is not None:
                no_masked_ids(res, tenants[names[c]])
    n_calls = sum(len(m) for m in calls)
    log(
        f"phase16 coalesced: {CALLERS} callers ({len(tenants)} tenant masks x 2 callers, "
        f"{CALLERS - 2 * len(tenants)} unfiltered) x {CALLER_QUERIES} strings for "
        f"{FILTER_CALL_S:.0f} s: {n_calls} calls in {co.batches_run} waves "
        f"({len([w for w in waves.values() if w[1] is not None])} filtered); each caller's first "
        f"and last result equal to a direct search at its wave's width and masks ({mixed} "
        f"of them filtered, {swaps} near-tie swaps), no masked id [{card}]"
    )


def phase_filtered(corpus, retr, card, profile: bool) -> dict:
    """Phase 16: filtered search on the card (ROADMAP item 7b), on phase 4's
    corpus and queries through phase 14's int8 retriever, then the fast and
    int4 arms on the same corpus and the pallas arm on phase 12's. Returns
    the filtered launches (and kernel A's time at group 5) for the
    ``kernels`` line."""
    rng = np.random.default_rng(16)
    picks = {p: rng.random(N_DOCS) < p for p in SELECTIVITIES}
    masks = {f"{p:.0%}".replace("%", " %"): picks[p] for p in SELECTIVITIES}
    include = make_filter_mask(N_DOCS, include_ids=rng.choice(N_DOCS, INCLUDE_DOCS, replace=False))
    int8 = filtered_int8(retr, corpus, masks, card, profile)
    starve = filtered_starvation(
        retr, corpus, {"include-list": include, "0.01 %": rng.random(N_DOCS) < 1e-4}, card
    )
    grouped = np.stack([np.ones(N_DOCS, bool), picks[0.5], picks[0.1], include])
    filtered_groups(retr, corpus, grouped, card)
    filtered_serving(retr, corpus, masks, grouped, card)
    filtered_coalesced(retr, {"tenant-a": picks[0.5], "tenant-b": picks[0.1]}, card)
    index, dense, term_ids, q, _ = corpus
    launches = {"i8_top2g": {n: int8[n]["launches"] for n in masks}}
    for kernel, counter in (("fast", "turbo_f32"), ("int4", "turbo_i4_top2")):
        arm = HybridRetriever(index, dense, kernel=kernel, device="cuda", device_batch=BATCH)
        launches[counter] = {
            name: filtered_arm(arm, term_ids, q, picks[p], counter, card, f"{kernel} {name}")
            for name, p in ARM_SELECTIVITIES
        }
        del arm
        free_device()
    s_index, s_emb, s_terms, s_q = small_corpus(corpus)
    small = HybridRetriever(
        s_index, DenseIndex.from_embeddings(s_emb, dtype=torch.bfloat16), device="cuda",
        device_batch=BATCH,
    )
    if small.kernel != "pallas":
        raise AssertionError(f"auto-select gave {small.kernel}, not pallas")
    launches["fused_topk"] = {
        name: filtered_arm(
            small, s_terms, s_q, rng.random(SMALL_DOCS) < p, "fused_topk", card, f"pallas {name}"
        )
        for name, p in ARM_SELECTIVITIES
    }
    extra = {name: {"filtered_launches": n} for name, n in launches.items()}
    extra["i8_top2g"]["group5"] = int8["a_group5"]
    extra["i8_top2g"]["filtered"] = {
        n: {k: v for k, v in int8[n].items() if k != "launches"} for n in masks
    }
    extra["i8_top2g"]["starvation"] = starve
    return extra


# ---------------------------------------------------------------------------
# Phase 17: serving a saved index from the port's own entry points
# ---------------------------------------------------------------------------


def strings_of(rng, n) -> list:
    """Query strings of the synthetic vocabulary's terms ("t123 t4567")."""
    return [" ".join(f"t{r}" for r in row) for row in term_ranks(rng, n)]


def cli_json(argv) -> list:
    """The port's CLI in this process; its ``json`` output, parsed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli_main(argv)
    if code != 0:
        raise AssertionError(f"cli {argv[:1]} exited {code}: {out.getvalue()[-500:]}")
    return json.loads(out.getvalue())


def hits_of(res, i) -> list:
    return [(int(d), float(s)) for d, s in zip(res.ids[i], res.scores[i]) if d >= 0]


def hit_arrays(rows) -> tuple:
    """A tool's or the CLI's rows of hits as padded (B, K) (scores, ids)."""
    ids = np.full((len(rows), K), -1, np.int32)
    vals = np.zeros((len(rows), K), np.float32)
    for i, row in enumerate(rows):
        for j, h in enumerate(row["hits"]):
            ids[i, j], vals[i, j] = h["doc_id"], h["score"]
    return vals, ids


def same_hits(payload, res) -> None:
    """The CLI's or a tool's hits are the direct result's, bit for bit."""
    for i, row in enumerate(payload):
        got = [(h["doc_id"], h["score"]) for h in row["hits"]]
        if got != hits_of(res, i):
            raise AssertionError(f"query {i}: {got[:3]} != {hits_of(res, i)[:3]}")


def tool(server, name, args) -> dict:
    """One ``tools/call`` through ``handle``, its result parsed; a tool
    error fails the phase."""
    msg = {"jsonrpc": "2.0", "id": 1, "method": "tools/call",
           "params": {"name": name, "arguments": args}}
    resp = asyncio.run(server.handle(msg))
    if resp["result"]["isError"]:
        raise AssertionError(f"{name}: {resp['result']['content'][0]['text']}")
    return json.loads(resp["result"]["content"][0]["text"])


def tool_error(server, name, args) -> str:
    msg = {"jsonrpc": "2.0", "id": 1, "method": "tools/call",
           "params": {"name": name, "arguments": args}}
    resp = asyncio.run(server.handle(msg))
    if not resp["result"]["isError"]:
        raise AssertionError(f"{name} answered where it must refuse")
    return resp["result"]["content"][0]["text"]


def entry_save_load(corpus, retr, tmp, card) -> tuple:
    """17.1: the pair saved and loaded back, bit-equal; a retriever over
    the loaded pair equal to phase 4's on 256 query strings."""
    index, dense = corpus[:2]
    prefix = f"{tmp}/big"
    t0 = time.perf_counter()
    save_index(prefix, index, dense)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(f"{tmp}/{f}") for f in os.listdir(tmp) if f.startswith("big."))
    t0 = time.perf_counter()
    postings = load_postings(f"{prefix}.postings.npz")
    rows = load_dense(f"{prefix}.dense.npz")
    load_s = time.perf_counter() - t0
    for name in ("term_offsets", "doc_ids", "tf", "impact", "df", "idf", "doc_len"):
        if not np.array_equal(getattr(postings, name), getattr(index, name)):
            raise AssertionError(f"loaded postings {name} differ")
    if not torch.equal(rows.embeddings.view(torch.int16), dense.embeddings.view(torch.int16)):
        raise AssertionError("loaded rows differ from the saved bf16 rows")
    t0 = time.perf_counter()
    loaded = HybridRetriever(postings, rows, device="cuda", device_batch=BATCH)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    strings = strings_of(np.random.default_rng(171), BATCH)
    want = retr.search(strings, k=K, candidates_per_arm=C_ARM)
    got, counts = counted(lambda: loaded.search(strings, k=K, candidates_per_arm=C_ARM))
    expect_launches(counts, i8_top2g=1)
    if not same_result(got, want):
        raise AssertionError("the loaded pair's results differ from phase 4's retriever")
    log(
        f"phase17 save/load: {N_DOCS} docs x {DIM} bf16 saved in {save_s:.2f} s "
        f"({nbytes / 1e6:.1f} MB on disk), loaded in {load_s:.2f} s (rows memory-mapped), "
        f"staged on the card in {stage_s:.2f} s; arrays bit-equal, {BATCH} query strings "
        f"bit-identical to phase 4's retriever, kernel A launches {counts['i8_top2g']} [{card}]"
    )
    return prefix, loaded, counts["i8_top2g"]


def entry_cli(prefix, loaded, card) -> int:
    """17.2: ``search`` in this process on 256 strings, plain and with
    ``--exclude-ids``: equal to a direct search; kernel A once each."""
    rng = np.random.default_rng(172)
    strings = strings_of(rng, BATCH)
    base = ["search", *strings, "--index", prefix, "--format", "json", "-k", str(K)]
    launches, times = 0, []
    direct = loaded.search(strings, k=K, candidates_per_arm=2 * K)
    excluded = sorted({d for i in range(BATCH) for d, _ in hits_of(direct, i)[:3]})
    spec = ",".join(map(str, excluded))
    for argv, kw in (
        (base, {}),
        (base + ["--exclude-ids", spec],
         {"filter_mask": make_filter_mask(N_DOCS, exclude_ids=excluded)}),
    ):
        t0 = time.perf_counter()
        payload, counts = counted(lambda: cli_json(argv))
        times.append(time.perf_counter() - t0)
        expect_launches(counts, i8_top2g=1)
        launches += counts["i8_top2g"]
        want = loaded.search(strings, k=K, candidates_per_arm=2 * K, **kw)
        same_hits(payload, want)
        if kw and any(h["doc_id"] in set(excluded) for row in payload for h in row["hits"]):
            raise AssertionError("an excluded id came back from the CLI")
    log(
        f"phase17 cli search: {BATCH} strings in one process call, {times[0]:.2f} s plain and "
        f"{times[1]:.2f} s with --exclude-ids ({len(excluded)} ids) from the index on disk "
        f"(load, staging, impact order, one step); json equal to a direct search bit for bit, "
        f"kernel A launches 1 each [{card}]"
    )
    return launches


def mcp_callers(
    server, tenants, names, card, label, make_strings=strings_of, seconds=MCP_CALL_S,
    phase="phase17", background=(), stats=None,
) -> int:
    """CALLERS concurrent callers of CALLER_QUERIES strings (from
    ``make_strings(rng, n)``), for ``seconds``, through ``handle`` on one
    event loop (as ``serve_stdio``);
    caller c sends per-query ``filters`` of ``tenants[names[c]]`` unless
    its name is None. Each caller's first and last response is held to a
    direct search at its wave's width and masks (near-tie rule), as in
    phases 15 and 16, reranked by the server's cross-encoder when it has
    one (``rerank_search_result`` over that search and the server's
    docs). Each coroutine function of ``background`` runs on the same loop
    beside the callers, given the time they stop. ``stats``, when given,
    receives the callers' q/s and latency percentiles. Returns kernel A's
    launches."""
    retr = server.retriever
    waves, where, wave_s = {}, {}, []
    lock = threading.Lock()
    search = retr.search

    def recording(queries, k, **kw):
        t = time.perf_counter()
        res = search(queries, k=k, **kw)
        with lock:
            wave_s.append(time.perf_counter() - t)
            waves[id(queries[0])] = (queries, kw.get("filter_mask"), kw.get("filter_group"))
            where.update((id(s), (id(queries[0]), r)) for r, s in enumerate(queries))
        return res

    retr.search = recording
    calls = [[] for _ in range(CALLERS)]

    async def caller(c, start):
        crng = np.random.default_rng(400 + c)
        while time.perf_counter() - start < seconds:
            strings = make_strings(crng, CALLER_QUERIES)
            args = {"queries": strings, "k": K}
            if names[c] is not None:
                args["filters"] = [tenants[names[c]]] * len(strings)
            msg = {"jsonrpc": "2.0", "id": c, "method": "tools/call",
                   "params": {"name": "search_corpus", "arguments": args}}
            t = time.perf_counter()
            resp = await server.handle(msg)
            calls[c].append((strings, resp, time.perf_counter() - t))

    async def all_callers():
        start = time.perf_counter()
        await asyncio.gather(
            *(caller(c, start) for c in range(CALLERS)),
            *(job(start + seconds) for job in background),
        )
        return time.perf_counter() - start

    waves_before = server.coalescer.batches_run
    elapsed, counts = counted(lambda: asyncio.run(all_callers()))
    del retr.search  # the class's method again
    if counts["i8_top2g"] < 1:
        raise AssertionError(f"kernel A did not launch: {counts}")
    expect_launches(counts, i8_top2g=counts["i8_top2g"])
    swaps, filtered = 0, 0
    for c, made in enumerate(calls):
        for strings, resp, _ in made:
            if resp["result"]["isError"]:
                raise AssertionError(resp["result"]["content"][0]["text"])
        for strings, resp, _ in (made[0], made[-1]):
            key, row = where[id(strings[0])]
            queries, masks, groups = waves[key]
            pad = [""] * (len(queries) - len(strings))
            kw = {}
            if masks is not None:
                filtered += 1
                present = np.unique(groups)
                tightest = present[np.argmin(masks[present].sum(axis=1))]
                own = groups[row : row + len(strings)]
                kw = {"filter_mask": masks, "filter_group": np.concatenate(
                    [own, np.full(len(pad), tightest, np.int32)])}
            ref = search(strings + pad, k=K, candidates_per_arm=2 * K, **kw)
            vals, ids = hit_arrays(json.loads(resp["result"]["content"][0]["text"])["results"])
            n = len(strings)
            ref = SearchResult(ids=ref.ids[:n], scores=ref.scores[:n])
            if server.reranker is not None:
                ref = rerank_search_result(server.reranker, strings, ref, server.docs)
            swaps += near_tie_check(vals, ids, ref.scores, ref.ids, atol=TIE)
            if names[c] is not None and set(ids[ids >= 0].tolist()) & set(
                tenants[names[c]]["exclude_ids"]
            ):
                raise AssertionError("an excluded id came back through search_corpus")
    n_calls = sum(len(c) for c in calls)
    lat = np.array([t for c in calls for _, _, t in c]) * 1e3
    wave_ms = np.array(wave_s) * 1e3
    n_waves = server.coalescer.batches_run - waves_before
    if stats is not None:
        stats.update(qps=n_calls * CALLER_QUERIES / elapsed, p50_ms=float(np.percentile(lat, 50)),
                     p99_ms=float(np.percentile(lat, 99)), waves=n_waves,
                     wave_p50_ms=float(np.percentile(wave_ms, 50)))
    log(
        f"{phase} mcp search_corpus, {label}: {CALLERS} callers x {CALLER_QUERIES} strings for "
        f"{elapsed:.2f} s through handle and the coalescer: {n_calls} calls in {n_waves} waves "
        f"(mean {n_calls * CALLER_QUERIES / max(n_waves, 1):.0f} queries), "
        f"{n_calls * CALLER_QUERIES / elapsed:.0f} q/s; caller latency p50 "
        f"{np.percentile(lat, 50):.1f} ms, p99 {np.percentile(lat, 99):.1f} ms; search per wave "
        f"p50 {np.percentile(wave_ms, 50):.1f} / p99 {np.percentile(wave_ms, 99):.1f} ms; each "
        f"caller's first and last response equal to a direct search at its wave's width and "
        f"masks{', reranked,' if server.reranker is not None else ''} ({filtered} filtered, "
        f"{swaps} near-tie swaps), kernel A launches "
        f"{counts['i8_top2g']} [{card}]"
    )
    return counts["i8_top2g"]


def entry_mcp(prefix, card) -> int:
    """17.3: ``build_server(index=prefix)`` and ``handle`` on
    ``search_corpus``: the callers of ``mcp_callers`` all unfiltered, then
    half of them with per-query ``filters`` (two tenants, two callers
    each). Then one call at k = 1,000 (kernel A at group 3) against the
    plain route."""
    server = build_server(index=prefix)
    retr = server.retriever
    rng = np.random.default_rng(173)
    tenants = {
        "tenant-a": {"exclude_ids": sorted(rng.choice(N_DOCS, 2_000, replace=False).tolist())},
        "tenant-b": {"exclude_ids": sorted(rng.choice(N_DOCS, 500, replace=False).tolist())},
    }
    tool(server, "search_corpus", {"queries": ["t1 t2"] * BATCH})  # warm
    launches = mcp_callers(server, tenants, [None] * CALLERS, card, "unfiltered")
    names = list(tenants) * 2 + [None] * (CALLERS - 2 * len(tenants))
    launches += mcp_callers(
        server, tenants, names, card, "2 tenants x 2 callers with per-query filters, 4 unfiltered"
    )
    # k = 1,000: 2,000 candidates per arm, kernel A at group 3
    strings = strings_of(rng, 16)
    got, counts1k = counted(lambda: tool(server, "search_corpus", {"queries": strings, "k": 1000}))
    expect_launches(counts1k, i8_top2g=1)
    prep = retr.prepare(
        [encode_query(retr.bm25.index, s) for s in strings], retr.dense.embedder(strings),
        k=1000, candidates_per_arm=2000,
    )
    plain = retr.finalize_prepared(prep, retr.run_prepared_device(prep, plain=True))
    same_hits(got["results"], plain)
    log(
        f"phase17 search_corpus at k=1000: 16 strings, 2,000 candidates per arm, kernel A at "
        f"group {T.auto_i8_group(N_DOCS, 2000)}, launches 1, every hit equal to the plain "
        f"route's ({sum(len(r['hits']) for r in got['results'])} hits) [{card}]"
    )
    return launches + counts1k["i8_top2g"]


def exact_live(upd, strings, c: int) -> np.ndarray:
    """The exact combined index of a live corpus: ``merge_postings`` plus
    the concatenated stored rows, f32 queries, the tombstone mask and RRF
    (the recall oracle of the live path). Returns (B, K) ids."""
    st = upd._st
    merged = merge_postings(upd.main_postings, st.delta_postings, st.n_total)
    rows = torch.cat([upd.base.dense._rescore_emb, st.delta_dense._emb_device])
    alive = torch.from_numpy(st.alive).cuda()
    term_ids = [encode_query(merged, s) for s in strings]
    plan = grouped_query_plan(
        merged, term_ids, st.alive[None, :], np.zeros(len(strings), np.int32),
        max_postings_per_term=auto_prune_m(st.n_total, c), multi_budget=max(256, c),
    )
    b_vals, b_ids = bm25_topk_device(
        torch.from_numpy(plan.doc_ids).cuda(), torch.from_numpy(plan.weights).cuda(),
        st.n_total, c, presorted=plan.presorted, max_run=plan.max_terms,
    )
    q32 = torch.from_numpy(upd.base.dense.embedder(strings)).cuda()
    _, d_ids = dense_topk_xla_masked(rows, q32, alive, c)
    return rrf_fuse_device(b_ids, d_ids, K)[1].cpu().numpy()


def live_step(upd, strings, kw) -> tuple:
    """The live search's synced time, its main dense arm's, and that arm's
    kernel call with its copy back alone: the difference is the host's
    compaction of the over-fetched pool."""
    st = upd._st
    base = upd.base
    q_dev = torch.from_numpy(base.dense.embedder(strings)).cuda().to(base.dense.query_dtype)
    masks = st.alive[None, : st.n_main]
    groups = np.zeros(len(strings), np.int32)
    unm = masks.sum(axis=1).astype(np.int64)
    c = kw["candidates_per_arm"]
    c_fetch = filtered_fetch_width(c, st.n_main, int(unm[0]))
    step = synced_ms(lambda: upd.search(strings, **kw), 3)
    arm = synced_ms(lambda: upd._dense_arm(base.dense, q_dev, c, masks, groups, unm, len(strings)), 3)
    kernel = synced_ms(lambda: [t.cpu() for t in base.dense._topk(q_dev, c_fetch)], 3)
    return step, arm, kernel, c_fetch


def entry_updatable(prefix, frozen, card) -> int:
    """17.4: ``--updatable`` at full width: 2,048 docs added, 1 % of the
    ids deleted, 256 strings through ``search_corpus``: bit-identical to
    the plain route, no deleted id, recall@10 against the exact combined
    index; the step beside the frozen index's."""
    server = build_server(index=prefix, updatable=True)
    upd = server.retriever
    rng = np.random.default_rng(174)
    texts = strings_of(np.random.default_rng(175), 2_048)
    texts = [t + " " + s for t, s in zip(texts, strings_of(rng, 2_048))]
    victims = sorted(rng.choice(N_DOCS + 2_048, (N_DOCS + 2_048) // 100, replace=False).tolist())
    t0 = time.perf_counter()
    added, counts_add = counted(lambda: tool(server, "index_documents", {"texts": texts}))
    add_s = time.perf_counter() - t0
    deleted, counts_del = counted(lambda: tool(server, "delete_documents", {"ids": victims}))
    delete_s = time.perf_counter() - t0 - add_s
    expect_launches(counts_add)
    expect_launches(counts_del)
    if added["ids"] != list(range(N_DOCS, N_DOCS + 2_048)):
        raise AssertionError("index_documents gave other ids")
    strings = strings_of(rng, BATCH)
    got, counts = counted(lambda: tool(server, "search_corpus", {"queries": strings, "k": K}))
    expect_launches(counts, i8_top2g=1)
    kw = {"k": K, "candidates_per_arm": 2 * K}
    plain = upd.search(strings, plain=True, **kw)
    same_hits(got["results"], plain)
    _, ids = hit_arrays(got["results"])
    if not upd._st.alive[ids[ids >= 0]].all():
        raise AssertionError("a deleted id came back")
    recall = recall_at_k(ids, exact_live(upd, strings, 2 * K))
    if recall < RECALL_FLOOR:
        raise AssertionError(f"live recall@{K} {recall:.4f} < {RECALL_FLOOR}")
    step, arm, kernel, c_fetch = live_step(upd, strings, kw)
    frozen_ms = synced_ms(lambda: frozen.search(strings, **kw), 3)
    log(
        f"phase17 updatable: {deleted['stats']['n_alive']} alive of "
        f"{deleted['stats']['n_main'] + deleted['stats']['n_delta']} ({added['stats']['n_delta']} "
        f"added in {add_s:.2f} s, {deleted['stats']['n_deleted']} deleted in {delete_s:.3f} s, "
        f"through handle); {BATCH} strings through search_corpus "
        f"bit-identical to the plain route, no deleted id, recall@{K} vs the exact combined "
        f"index {recall:.4f}, kernel A launches {counts['i8_top2g']}; search {step:.1f} ms "
        f"against the frozen index's {frozen_ms:.1f} ms (host clock, synced, median of 3); main "
        f"dense arm {arm:.1f} ms, of it kernel call and copy back {kernel:.1f} ms at a fetch of "
        f"{c_fetch}, host compaction {arm - kernel:.1f} ms [{card}]"
    )
    return counts["i8_top2g"]


def entry_small(corpus, tmp, card) -> int:
    """17.5: phase 12's corpus (kernel B): the live corpus against
    ``HybridRetriever(fusion="rrf")`` over the combined index (near-tie
    rule), ``compact_corpus`` with ``save`` served again by a fresh server,
    the pallas hybrid refused at k = 1,000 before any launch; then
    ``index`` on phase 5's texts and ``search`` on it, equal to
    ``HybridRetriever.build``."""
    s_index, s_emb, _, _ = small_corpus(corpus)
    prefix = f"{tmp}/small"
    save_index(prefix, s_index, DenseIndex.from_embeddings(s_emb, dtype=torch.bfloat16))
    server = build_server(index=prefix, updatable=True)
    upd = server.retriever
    if upd.kernel != "pallas":
        raise AssertionError(f"auto-select gave {upd.kernel}, not pallas")
    rng = np.random.default_rng(176)
    tool(server, "index_documents", {"texts": strings_of(rng, 512)})
    tool(server, "delete_documents", {
        "ids": sorted(rng.choice(SMALL_DOCS + 512, (SMALL_DOCS + 512) // 100, replace=False).tolist())
    })
    strings = strings_of(rng, BATCH)
    got, counts = counted(lambda: tool(server, "search_corpus", {"queries": strings, "k": K}))
    expect_launches(counts, fused_topk=1)
    launches = counts["fused_topk"]
    st = upd._st
    merged = merge_postings(upd.main_postings, st.delta_postings, st.n_total)
    rows = torch.cat([upd.base.dense._emb_device[:, :DIM], st.delta_dense._emb_device]).cpu()
    combined = HybridRetriever(
        merged, DenseIndex(embeddings=rows, n_docs=st.n_total, dim=DIM), fusion="rrf",
        device="cuda", device_batch=BATCH,
    )
    want = combined.search(strings, k=K, candidates_per_arm=2 * K, filter_mask=st.alive)
    vals, ids = hit_arrays(got["results"])
    swaps = near_tie_check(vals, ids, want.scores, want.ids, atol=TIE)
    out = tool(server, "compact_corpus", {"save": True})
    after = tool(server, "search_corpus", {"queries": strings, "k": K})
    fresh = build_server(index=prefix, updatable=True)
    again, counts2 = counted(lambda: tool(fresh, "search_corpus", {"queries": strings, "k": K}))
    expect_launches(counts2, fused_topk=1)
    launches += counts2["fused_topk"]
    if again != after:
        raise AssertionError("the saved compacted pair serves other results")
    frozen = build_server(index=prefix)
    message, counts3 = counted(lambda: tool_error(frozen, "search_corpus", {"queries": strings[:4], "k": 1000}))
    expect_launches(counts3)
    if "must not exceed the corpus block size" not in message:
        raise AssertionError(f"k=1000 on kernel B: {message}")
    log(
        f"phase17 small live corpus: {SMALL_DOCS} + 512 docs, 1 % deleted, {BATCH} strings equal "
        f"to HybridRetriever(fusion=rrf) over the combined index ({swaps} near-tie swaps), "
        f"kernel B launches 1; compact_corpus save=true ({out['n_docs']} docs, renumbered "
        f"{out['ids_renumbered']}) then a fresh server over the saved pair: equal results "
        f"(kernel B launches 1); k=1000 on the pallas hybrid refused "
        f"before any launch ({message[:60]}) [{card}]"
    )
    docs, text_queries = text_corpus()
    path = f"{tmp}/texts.txt"
    with open(path, "w") as f:
        f.write("\n".join(docs) + "\n")
    out_buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out_buf):
        if cli_main(["index", path, "--out", f"{tmp}/texts"]) != 0:
            raise AssertionError(f"cli index failed: {out_buf.getvalue()}")
    index_s = time.perf_counter() - t0
    payload, counts4 = counted(lambda: cli_json(
        ["search", *text_queries, "--index", f"{tmp}/texts", "--format", "json", "-k", str(K)]
    ))
    expect_launches(counts4, fused_topk=1)
    launches += counts4["fused_topk"]
    built = HybridRetriever.build([d.strip() for d in docs if d.strip()], device="cuda")
    same_hits(payload, built.search(text_queries, k=K, candidates_per_arm=2 * K))
    log(
        f"phase17 cli index + search: {len(docs)} docs indexed in {index_s:.2f} s, "
        f"{len(text_queries)} queries by kernel B (launches 1) equal bit for bit to "
        f"HybridRetriever.build on the same texts [{card}]"
    )
    return launches


def phase_entry_points(corpus, retr, card) -> dict:
    """Phase 17: the port's entry points on the card (ROADMAP items 7a, 10
    and 14's ``index``). Returns kernel A's and B's launches per step for
    the ``kernels`` line."""
    with tempfile.TemporaryDirectory(prefix="oi_phase17_") as tmp:
        prefix, loaded, a_load = entry_save_load(corpus, retr, tmp, card)
        a_cli = entry_cli(prefix, loaded, card)
        del loaded
        free_device()
        a_mcp = entry_mcp(prefix, card)
        free_device()
        a_live = entry_updatable(prefix, retr, card)
        free_device()
        b_small = entry_small(corpus, tmp, card)
        free_device()
    return {
        "i8_top2g": {"entry_point_launches": {
            "load": a_load, "cli": a_cli, "mcp": a_mcp, "updatable": a_live}},
        "fused_topk": {"entry_point_launches": {"small_live_and_cli": b_small}},
    }


# ---------------------------------------------------------------------------
# Phase 18: the encoder loop (ROADMAP item 11)
# ---------------------------------------------------------------------------

# the repo's encoder quality run (docs/encoder_quality.json): its corpus,
# batch, lr and flip_p; its 8,000 steps cut to ENC_STEPS; the CLI's
# default EncoderConfig (32,768 x 256, depth 4, heads 4, mlp x4, 128)
ENC_DOCS, ENC_CONCEPTS, ENC_STEPS, ENC_BATCH, ENC_LR, ENC_FLIP = 100_000, 2_000, 200, 96, 1.5e-3, 0.5
ENC_TOL = 1e-5  # the card against the CPU, f32 (TF32 off): sums in other orders
ENC_BF16_TOL = 2e-2  # bf16: the first block's products round at other places
ENC_COMPARE = 2_048  # docs encoded on both sides
ENC_REPS = 3  # runs of each timed entry-point step (median)
ENC_CALL_S = 2.0  # seconds of concurrent search_corpus callers
ENC_ADDS = 512  # docs added to the live corpus


@contextlib.contextmanager
def timing(owner, name: str, acc: list):
    """``owner.name`` wrapped for the block: each call's seconds (host
    clock, the card synced at its end) appended to ``acc``."""
    fn = getattr(owner, name)

    def wrapped(*args, **kw):
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.synchronize()
            acc.append(time.perf_counter() - t)

    setattr(owner, name, wrapped)
    try:
        yield acc
    finally:
        setattr(owner, name, fn)


def encoder_queries(docs, syn, rng, n, flip_p) -> tuple[list, np.ndarray]:
    """The quality run's self-labelled queries (``models/eval.py``'s
    ``synthetic_qrels``): 4 distinct tokens of a random doc, each flipped
    to its synonym surface with ``flip_p``; (strings, the docs' ids)."""
    ids = rng.integers(0, len(docs), size=n)
    out = []
    for d in ids:
        tokens = docs[int(d)].split()
        chosen = list(rng.choice(tokens, size=min(4, len(tokens)), replace=False))
        out.append(" ".join(flip_tokens(chosen, syn, flip_p, rng)))
    return out, ids


def encoder_train(docs, syn, tmp, card, profile: bool) -> str:
    """18.1: ``train_encoder`` on the card; then one more step resumed
    from its checkpoint on the card and on the CPU, held together."""
    import shutil

    ck = f"{tmp}/ck"
    starts = []
    make_pairs = train_mod.make_pairs

    def stamped(*args, **kw):  # a step starts with its batch
        starts.append(time.perf_counter())
        return make_pairs(*args, **kw)

    train_mod.make_pairs = stamped
    try:
        t0 = time.perf_counter()
        res = train_encoder(
            docs, EncoderConfig(), steps=ENC_STEPS, batch_size=ENC_BATCH, lr=ENC_LR, seed=0,
            ckpt_dir=ck, ckpt_every=ENC_STEPS, synonym_map=syn, flip_p=ENC_FLIP, device="cuda",
        )
        total_s = time.perf_counter() - t0
    finally:
        train_mod.make_pairs = make_pairs
    losses = np.array(res.losses)
    if losses.shape != (ENC_STEPS,) or not np.isfinite(losses).all():
        raise AssertionError(f"training gave losses {losses[:4]}...")
    head, tail = losses[:10].mean(), losses[-10:].mean()
    if not tail < head:
        raise AssertionError(f"the loss did not fall: first 10 {head:.4f}, last 10 {tail:.4f}")
    step_ms = statistics.median(np.diff(starts)[1:]) * 1e3
    n_params = sum(p.numel() for p in res.params.parameters())
    cfg = res.params.cfg
    if profile:  # further steps of the trained model (the checkpoint is saved)
        model, rng = res.params, np.random.default_rng(1)
        embedder, opt = NeuralEmbedder(cfg, model, device="cuda"), train_mod._adamw(model, ENC_LR)

        def step():
            batch = train_mod.make_pairs(
                docs, embedder, ENC_BATCH, rng, synonym_map=syn, flip_p=ENC_FLIP, device="cuda"
            )
            opt.zero_grad(set_to_none=True)
            loss = info_nce_loss(model, *batch)
            loss.backward()
            opt.step()
            return loss.item()

        log(f"profile train: {profile_calls(step, 5, 1, 'step')} [{card}]")
    del res
    free_device()
    resumed, secs = {}, {}
    for dev in ("cuda", "cpu"):
        shutil.copytree(ck, f"{tmp}/ck_{dev}")
        t0 = time.perf_counter()
        resumed[dev] = train_encoder(
            docs, EncoderConfig(), steps=ENC_STEPS + 1, batch_size=ENC_BATCH, lr=ENC_LR, seed=0,
            ckpt_dir=f"{tmp}/ck_{dev}", synonym_map=syn, flip_p=ENC_FLIP, device=dev,
        )
        secs[dev] = time.perf_counter() - t0
    w_err = max(
        float((a.detach().cpu() - b.detach()).abs().max())
        for a, b in zip(resumed["cuda"].params.parameters(), resumed["cpu"].params.parameters())
    )
    l_card, l_cpu = resumed["cuda"].losses[0], resumed["cpu"].losses[0]
    if w_err > ENC_TOL or abs(l_card - l_cpu) > ENC_TOL * abs(l_cpu):
        raise AssertionError(f"one resumed step: weights differ by {w_err:.3g}, loss {l_card} vs {l_cpu}")
    log(
        f"phase18 train: {n_params:,} parameters (vocab {cfg.vocab_size}, dim {cfg.dim}, depth "
        f"{cfg.depth}, heads {cfg.heads}, mlp x{cfg.mlp_ratio}, max_len {cfg.max_len}), "
        f"{ENC_STEPS} steps of batch {ENC_BATCH} at lr {ENC_LR} on {ENC_DOCS} synonym docs in "
        f"{total_s:.2f} s; median step {step_ms:.2f} ms (host clock, synced by the loss, batch "
        f"making included); loss {losses[0]:.4f} at step 0 -> {losses[-1]:.4f} at step "
        f"{ENC_STEPS - 1} (mean of the first 10 {head:.4f}, of the last 10 {tail:.4f}); one "
        f"more step resumed from the checkpoint on the card ({secs['cuda']:.2f} s) and on "
        f"the CPU ({secs['cpu']:.2f} s): weights within {w_err:.3g} (<= {ENC_TOL}), loss "
        f"{l_card:.6f} vs {l_cpu:.6f} [{card}]"
    )
    del resumed
    free_device()
    return ck


def encoder_encode(docs, ck, card, profile: bool) -> None:
    """18.2: 2,048 docs encoded on the card and on the CPU from the same
    weights, f32 and a bf16 config."""
    texts = docs[:ENC_COMPARE]
    host = load_embedder(ck, device="cpu")
    errs, times = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(host.cfg, dtype=dtype)
        tree = convert.encoder_tree(host.params)
        on_card = NeuralEmbedder(cfg, convert.encoder_params(tree, cfg), device="cuda")
        on_host = NeuralEmbedder(cfg, convert.encoder_params(tree, cfg), device="cpu")
        got = on_card(texts)
        times[dtype] = statistics.median(synced_ms(lambda: on_card(texts)) for _ in range(ENC_REPS))
        errs[dtype] = float(np.abs(got - on_host(texts)).max())
        if profile:
            log(f"profile encode {dtype}: {profile_calls(lambda: on_card(texts), 3, 1, 'chunk of 2,048 docs')} [{card}]")
        del on_card
    if errs["float32"] > ENC_TOL or errs["bfloat16"] > ENC_BF16_TOL:
        raise AssertionError(f"the card's encoding differs from the CPU's: {errs}")
    log(
        f"phase18 encode: {ENC_COMPARE} docs on the card against the port on the CPU, same "
        f"weights: f32 max abs err {errs['float32']:.3g} (<= {ENC_TOL}), bf16 config "
        f"{errs['bfloat16']:.3g} (<= {ENC_BF16_TOL}); on the card {times['float32']:.1f} ms f32, "
        f"{times['bfloat16']:.1f} ms bf16 (tokenising included, median of {ENC_REPS}) [{card}]"
    )


def encoder_index(path, ck, prefix, card, phase: str = "phase18", reps: int = ENC_REPS) -> None:
    """18.3 (and 22.5): ``index --encoder`` through the CLI, split into
    host tokenising, encoding on the card, the BM25 build and the save."""
    runs = []
    for _ in range(reps):
        tok, enc, bm25, save = [], [], [], []
        out = io.StringIO()
        with contextlib.ExitStack() as stack:
            stack.enter_context(timing(NeuralEmbedder, "tokenize", tok))
            stack.enter_context(timing(NeuralEmbedder, "_encode", enc))
            stack.enter_context(timing(index_build, "build_postings_index", bm25))
            stack.enter_context(timing(index_checkpoint, "save_index", save))
            stack.enter_context(contextlib.redirect_stdout(out))
            t0 = time.perf_counter()
            code = cli_main(["index", path, "--out", prefix, "--encoder", ck])
            total = time.perf_counter() - t0
        if code != 0 or f"indexed {ENC_DOCS} docs" not in out.getvalue():
            raise AssertionError(f"cli index --encoder: {out.getvalue()[-300:]}")
        runs.append((total, sum(tok), sum(enc) - sum(tok), sum(bm25), sum(save)))
    total, tok_s, enc_s, bm25_s, save_s = (statistics.median(col) for col in zip(*runs))
    meta = json.loads(open(f"{prefix}.meta.json").read())
    if meta != {"embedder": "neural", "dim": 256, "dense_store": "f32"}:
        raise AssertionError(f"index meta {meta}")
    log(
        f"{phase} cli index --encoder: {ENC_DOCS} docs in {total:.2f} s (median of {reps}): "
        f"host tokenising {tok_s:.2f} s, encoding on the card {enc_s:.2f} s "
        f"({ENC_DOCS / enc_s:,.0f} docs a second, copies included), BM25 build {bm25_s:.2f} s, "
        f"save {save_s:.2f} s, the rest {total - tok_s - enc_s - bm25_s - save_s:.2f} s [{card}]"
    )


def encoder_search(prefix, ck, docs, syn, card, phase: str = "phase18") -> dict:
    """18.4 and 18.5 (and 22.5): ``search --encoder`` through the CLI on
    256 strings (128 mismatch, 128 exact), equal to a direct search;
    kernel A's cells at 256 x 100,000 x 256 against its twin, recall@10
    against the exact path; then ``--kernel pallas`` through kernel B.
    Returns A's and B's records for this width."""
    rng = np.random.default_rng(184)
    mismatch, m_ids = encoder_queries(docs, syn, rng, BATCH // 2, 1.0)
    exact_q, e_ids = encoder_queries(docs, syn, rng, BATCH // 2, 0.0)
    strings, labels = mismatch + exact_q, np.concatenate([m_ids, e_ids])
    emb = load_embedder(ck)
    postings, rows = load_postings(f"{prefix}.postings.npz"), load_dense(f"{prefix}.dense.npz")
    base = ["search", *strings, "--index", prefix, "--encoder", ck, "--format", "json", "-k", str(K)]
    q_ms = statistics.median(synced_ms(lambda: emb(strings)) for _ in range(ENC_REPS))
    out = {}
    for kernel, counter in (("auto", "i8_top2g"), ("pallas", "fused_topk")):
        times, launches = [], 0
        for _ in range(ENC_REPS):
            t0 = time.perf_counter()
            payload, counts = counted(lambda: cli_json(base + ["--kernel", kernel]))
            times.append(time.perf_counter() - t0)
            expect_launches(counts, **{counter: 1})
            launches += counts[counter]
        retr = HybridRetriever(
            postings, rows, emb, kernel=None if kernel == "auto" else kernel, device="cuda",
            device_batch=BATCH,
        )
        if retr.kernel != ("int8" if kernel == "auto" else "pallas"):
            raise AssertionError(f"auto-select gave {retr.kernel}")
        want = retr.search(strings, k=K, candidates_per_arm=2 * K)
        vals, ids = hit_arrays(payload)
        swaps = near_tie_check(vals, ids, want.scores, want.ids, atol=TIE)
        term_ids, q_emb = [encode_query(retr.bm25.index, s) for s in strings], emb(strings)
        prep = retr.prepare(term_ids, q_emb, k=K, candidates_per_arm=2 * K)
        if kernel == "auto":
            out[counter] = encoder_kernel_a(retr, prep, card)
            served = retr.finalize_prepared(prep, retr.run_prepared_device(prep))
            recall = recall_at_k(served.ids, exact_hybrid(retr, prep, retr.dense._rescore_emb, prep.queries))
            if recall < RECALL_FLOOR:
                raise AssertionError(f"recall@{K} {recall:.4f} < {RECALL_FLOOR}")
            dense = retr.dense.search(strings, k=K)
            hit = (dense.ids == labels[:, None]).any(axis=1)
            hyb = (want.ids == labels[:, None]).any(axis=1)
            n = BATCH // 2
            prep_ms = statistics.median(
                synced_ms(lambda: retr.prepare(term_ids, q_emb, k=K, candidates_per_arm=2 * K))
                for _ in range(ENC_REPS)
            )
            run_ms = statistics.median(
                synced_ms(lambda: retr.run_prepared_device(prep)) for _ in range(ENC_REPS)
            )
            extra = (
                f"recall@{K} against the exact path {recall:.4f} (>= {RECALL_FLOOR}); against "
                f"the generator's labels: neural dense {hit[:n].mean():.3f} mismatch, "
                f"{hit[n:].mean():.3f} exact, hybrid {hyb[:n].mean():.3f} mismatch, "
                f"{hyb[n:].mean():.3f} exact (no limit: {ENC_STEPS} steps, not 8,000); 256 "
                f"queries encoded on the card in {q_ms:.2f} ms, prepare (host BM25 plan of width "
                f"{prep.plan_doc_ids.shape[2]}: pruning M {auto_prune_m(ENC_DOCS, 2 * K)}) "
                f"{prep_ms:.1f} ms, the step {run_ms:.1f} ms (medians of {ENC_REPS})"
            )
        else:
            out[counter] = encoder_kernel_b(retr, prep, card)
            extra = "kernel B at k = 20"
        out[counter]["encoder_launches"] = {"cli_search": launches}
        log(
            f"{phase} cli search --encoder --kernel {kernel}: {BATCH} strings ({BATCH // 2} "
            f"mismatch, {BATCH // 2} exact) in {statistics.median(times):.2f} s a process call "
            f"(median of {ENC_REPS}, load and encoding included), {counter} launches 1 each; "
            f"json equal to a direct search ({swaps} near-tie swaps); {extra} [{card}]"
        )
        del retr
        free_device()
    return out


def encoder_kernel_a(retr, prep, card) -> dict:
    q8 = prep.queries_i8[0].contiguous()
    corpus = retr.dense._emb_device
    group = T.auto_i8_group(ENC_DOCS, 2 * K)
    sub = retr._dense_block_c(BATCH) // 128
    got = T.i8_top2g_cells(q8, corpus, group=group, sub=sub)
    want = T.i8_top2g_cells_plain(q8, corpus, group=group, sub=sub)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("kernel A's cells at D=256 differ from its twin")
    a_ms = cuda_ms(lambda: T.i8_top2g_cells(q8, corpus, group=group, sub=sub), 20, warmup=2)
    plain_ms = cuda_ms(lambda: T.i8_top2g_cells_plain(q8, corpus, group=group, sub=sub), 3)
    limit = bound((q8, corpus), got, product_ops(q8, corpus), "int8")
    log(
        f"kernel A at B={BATCH}, N={ENC_DOCS} ({corpus.shape[0]} padded), D=256, group={group}, "
        f"sub={sub}: cells bit-identical to the twin; {a_ms:.4f} ms (events, 20 launches), "
        f"twin {plain_ms:.3f} ms; bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}), "
        f"share {limit['bound_ms'] / a_ms:.3f} [{card}]"
    )
    return {"d256": {"ms": a_ms, "plain_ms": plain_ms, "max_abs_err": 0, **limit}}


def encoder_kernel_b(retr, prep, card) -> dict:
    q = prep.queries[0].contiguous()
    rows = retr.dense._emb_device
    c = 2 * K
    vals, ids = T.dense_topk_pallas(rows, q, k=c)
    p_vals, p_ids = T.dense_topk_pallas(rows, q, k=c, plain=True)
    swaps = near_tie_check(vals.cpu(), ids.cpu(), p_vals.cpu(), p_ids.cpu(), atol=ATOL)
    err = float((vals - p_vals).abs()[ids == p_ids].max())
    b_ms = cuda_ms(lambda: T.dense_topk_pallas(rows, q, k=c), 20, warmup=2)
    plain_ms = cuda_ms(lambda: T.dense_topk_pallas(rows, q, k=c, plain=True), 3)
    limit = bound((q, rows), (vals, ids), product_ops(q, rows), "f32")
    log(
        f"kernel B at B={BATCH}, N={ENC_DOCS}, D=256, f32, k={c}: against its twin by the "
        f"near-tie rule ({swaps} swaps, max abs err {err:.3g} <= {ATOL}); {b_ms:.4f} ms (events, "
        f"20 launches), twin {plain_ms:.3f} ms; bound {limit['bound_ms']:.4f} ms "
        f"({limit['bound_by']}), share {limit['bound_ms'] / b_ms:.3f} [{card}]"
    )
    return {"d256": {"ms": b_ms, "plain_ms": plain_ms, "max_abs_err": err, **limit}}


def encoder_mcp(prefix, ck, docs, syn, card) -> dict:
    """18.6: ``build_server(index, encoder)``: 8 callers x 64 strings
    through ``search_corpus``; then ``--updatable``: 512 texts embedded on
    the card by ``index_documents``, 1 % of the ids deleted, and a search
    equal to the plain route with no deleted id."""
    def make_strings(rng, n):
        return encoder_queries(docs, syn, rng, n, ENC_FLIP)[0]

    server = build_server(index=prefix, encoder=ck)
    rng = np.random.default_rng(185)
    tool(server, "search_corpus", {"queries": make_strings(rng, 4)})  # warm
    one = [make_strings(rng, CALLER_QUERIES) for _ in range(ENC_REPS + 2)]
    alone = statistics.median(
        synced_ms(lambda: tool(server, "search_corpus", {"queries": s, "k": K})) for s in one
    )
    log(
        f"phase18 mcp search_corpus, one caller alone: {CALLER_QUERIES} strings a call, "
        f"{alone:.1f} ms (median of {len(one)}) [{card}]"
    )
    a_mcp = 0
    for label in ("the encoder index, first round", "the encoder index, second round"):
        a_mcp += mcp_callers(
            server, {}, [None] * CALLERS, card, label, make_strings=make_strings,
            seconds=ENC_CALL_S, phase="phase18",
        )
    del server
    free_device()
    server = build_server(index=prefix, encoder=ck, updatable=True)
    upd = server.retriever
    rng = np.random.default_rng(186)
    texts = synthetic_synonym_corpus(ENC_ADDS, n_concepts=ENC_CONCEPTS, seed=186)[0]
    t0 = time.perf_counter()
    added, counts_add = counted(lambda: tool(server, "index_documents", {"texts": texts}))
    add_s = time.perf_counter() - t0
    expect_launches(counts_add)
    if added["ids"] != list(range(ENC_DOCS, ENC_DOCS + ENC_ADDS)):
        raise AssertionError("index_documents gave other ids")
    want_rows = upd.base.dense.embedder(texts)
    if float(np.abs(upd._st.delta_emb - want_rows).max()) > ENC_TOL:
        raise AssertionError("the added docs' rows are not the encoder's")
    n_total = ENC_DOCS + ENC_ADDS
    victims = sorted(rng.choice(n_total, n_total // 100, replace=False).tolist())
    tool(server, "delete_documents", {"ids": victims})
    strings = make_strings(rng, BATCH)
    got, counts = counted(lambda: tool(server, "search_corpus", {"queries": strings, "k": K}))
    expect_launches(counts, i8_top2g=1)
    same_hits(got["results"], upd.search(strings, plain=True, k=K, candidates_per_arm=2 * K))
    _, ids = hit_arrays(got["results"])
    if not upd._st.alive[ids[ids >= 0]].all():
        raise AssertionError("a deleted id came back")
    log(
        f"phase18 updatable --encoder: {ENC_ADDS} texts embedded on the card by index_documents "
        f"in {add_s:.2f} s (the first add builds the main view's impact order), rows equal to "
        f"the encoder's; {len(victims)} ids deleted; {BATCH} strings through search_corpus "
        f"bit-identical to the plain route, no deleted id, kernel A launches 1 [{card}]"
    )
    return {"mcp": a_mcp, "updatable": counts["i8_top2g"]}


def encoder_refusals(prefix, ck) -> None:
    """18.7: ``search --encoder --mesh 2x4`` on fewer than 8 cards exits 1
    with the reference's text."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli_main(["search", "x", "--index", prefix, "--encoder", ck, "--mesh", "2x4"])
    n_cards = torch.cuda.device_count()
    want = f"error: --mesh 2x4: mesh 2x4 != {n_cards} devices"
    if n_cards < 8 and (code, out.getvalue().strip()) != (1, want):
        raise AssertionError(f"search --mesh: exit {code}, {out.getvalue()!r}")


def phase_encoder(card, profile: bool, tmp: str) -> tuple[dict, dict]:
    """Phase 18: the encoder loop at the full width of the model the repo
    ships, on the quality run's corpus, in the directory ``tmp``. Returns
    kernel A's and B's records for the ``kernels`` line, and what phase 19
    reuses: the corpus, its synonyms, the trained checkpoint and the saved
    index."""
    t0 = time.perf_counter()
    docs, syn = synthetic_synonym_corpus(ENC_DOCS, n_concepts=ENC_CONCEPTS, seed=0)
    path = f"{tmp}/synonym.txt"
    with open(path, "w") as f:
        f.write("\n".join(docs) + "\n")
    log(f"setup phase18: {ENC_DOCS} synonym docs, {ENC_CONCEPTS} concepts ({time.perf_counter() - t0:.1f}s)")
    ck = encoder_train(docs, syn, tmp, card, profile)
    encoder_encode(docs, ck, card, profile)
    prefix = f"{tmp}/enc"
    encoder_index(path, ck, prefix, card)
    records = encoder_search(prefix, ck, docs, syn, card)
    launches = encoder_mcp(prefix, ck, docs, syn, card)
    records["i8_top2g"]["encoder_launches"].update(launches)
    encoder_refusals(prefix, ck)
    log(
        f"phase18 refusals: search --mesh 2x4 on {torch.cuda.device_count()} card(s) exits 1 "
        f"with the reference's text [{card}]"
    )
    free_device()
    return records, {"docs": docs, "syn": syn, "path": path, "ck": ck, "prefix": prefix}


# ROADMAP item 12 at the width of phase 18's model: the CLI's train
# --steps 200 gives the reranker max(10, 200 // 2) = 100 steps of 8
# queries x 4 candidates and the analyzer max(20, 200) = 200 steps of 64
NOW = datetime.datetime(2026, 6, 24, tzinfo=datetime.timezone.utc)
RR_STEPS, AN_STEPS = max(10, ENC_STEPS // 2), max(20, ENC_STEPS)  # the CLI's rule
RR_PAIRS = 512  # pairs scored on the card and on the CPU
EVAL_DOCS, EVAL_QUERIES = 20_000, 512  # evaluate --rerank
LEX_POSTS = 100_000  # lexicon posts, and texts through the neural analyzer
WATCH_TICKERS, WATCH_SIGNALS = 64, 2_000  # aggregate_batch's watchlist
BIG_B, BIG_N = 1_024, 1_024  # aggregate_batch at 1M elements, timed
ATR_TICKERS, ATR_BARS = 512, 250
GATE_MARGIN = 1e-4  # watchlist cases this close to an alignment gate are drawn again
ENGINE_TOL = 1e-6  # aggregate_batch and atr_batch, the card against the CPU (f32)
SCALAR_TOL = 1e-5  # against the scalar engine and atr (f64 on the host)


def item12_train(path, syn, ck, tmp, card) -> None:
    """19.1: ``train --reranker --analyzer`` through the CLI on phase 18's
    corpus and checkpoint (already at its steps, so the encoder is not
    trained again): 100 reranker steps warm-started from the encoder and
    200 analyzer steps on the frozen encoder. Each step is stamped where
    its loss is computed; the card's share comes from ``torch.profiler``
    over 5 more steps of each on one batch (pair encoding or tokenising
    included, the negative mining not)."""
    from openintel_tpu_torch.models import neural_analyzer as NA
    from openintel_tpu_torch.models import reranker as RR

    syn_path = f"{tmp}/synonyms.tsv"
    with open(syn_path, "w") as f:
        f.write("".join(f"{a}\t{b}\n" for a, b in syn.items()))
    with open(f"{ck}/encoder.npz", "rb") as f:
        before = f.read()
    stamps = {"reranker": [], "analyzer": []}
    losses = {"reranker": [], "analyzer": []}

    def stamped(name, fn):
        def wrapped(*args, **kw):
            stamps[name].append(time.perf_counter())
            loss = fn(*args, **kw)
            losses[name].append(loss.detach())
            return loss

        return wrapped

    originals = RR.listwise_loss, NA.distill_loss
    RR.listwise_loss = stamped("reranker", RR.listwise_loss)
    NA.distill_loss = stamped("analyzer", NA.distill_loss)
    out = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = cli_main([
                "train", path, "--out", ck, "--steps", str(ENC_STEPS), "--batch-size", str(ENC_BATCH),
                "--lr", str(ENC_LR), "--synonyms", syn_path, "--flip-p", str(ENC_FLIP),
                "--reranker", "--analyzer",
            ])
        total_s = time.perf_counter() - t0
    finally:
        RR.listwise_loss, NA.distill_loss = originals
    text = out.getvalue()
    for needle in (f"checkpoint already at step {ENC_STEPS}; nothing to do",
                   f"analyzer head distilled ({AN_STEPS} steps", f"reranker trained ({RR_STEPS} steps"):
        if code != 0 or needle not in text:
            raise AssertionError(f"cli train --reranker --analyzer: exit {code}, {text[-500:]!r}")
    with open(f"{ck}/encoder.npz", "rb") as f:
        if f.read() != before:
            raise AssertionError("training the heads changed the encoder's checkpoint")
    parts = []
    for name, n in (("reranker", RR_STEPS), ("analyzer", AN_STEPS)):
        curve = np.array([x.item() for x in losses[name]])
        if curve.shape != (n,) or not np.isfinite(curve).all():
            raise AssertionError(f"{name}: losses {curve[:4]}... ({curve.size})")
        head, tail = curve[:10].mean(), curve[-10:].mean()
        if not tail < head:
            raise AssertionError(f"{name}: the loss did not fall ({head:.4f} -> {tail:.4f})")
        step = statistics.median(np.diff(stamps[name])[1:]) * 1e3
        parts.append(
            f"{name} {n} steps, median step {step:.2f} ms, loss {curve[0]:.4f} -> {curve[-1]:.4f} "
            f"(first 10 {head:.4f}, last 10 {tail:.4f})"
        )
    log(
        f"phase19 cli train --reranker --analyzer on phase 18's checkpoint ({ENC_DOCS} docs, "
        f"the encoder left as it was, bytes equal): {'; '.join(parts)}; {total_s:.2f} s in all "
        f"(host clock, synced by each loss; the reranker's step includes its negative mining "
        f"and pair encoding, the analyzer's its tokenising) [{card}]"
    )
    # the card's share of a step: 5 more steps of each on one batch
    rr = RR.load_reranker(ck)
    for v in rr.head.values():
        v.requires_grad_()
    opt = torch.optim.AdamW([*rr.params.parameters(), *rr.head.values()], lr=ENC_LR,
                            betas=train_mod.BETAS, eps=train_mod.EPS, weight_decay=train_mod.WEIGHT_DECAY)
    with open(path) as f:
        first = [next(f).strip() for _ in range(64)]
    queries = [" ".join(d.split()[:3]) for d in first[:8]]
    cands = [first[4 * i : 4 * i + 4] for i in range(8)]

    def rr_step():
        ids, mask = rr.encode_pairs(queries, cands)
        opt.zero_grad(set_to_none=True)
        loss = RR.listwise_loss(rr.params, rr.head, torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda(), 4)
        loss.backward()
        opt.step()
        return loss.item()

    an = NA.load_analyzer(ck)
    head = {k: v.clone().requires_grad_() for k, v in an.head.items()}
    an_opt = torch.optim.AdamW(list(head.values()), lr=3e-3, betas=train_mod.BETAS, eps=train_mod.EPS,
                               weight_decay=train_mod.WEIGHT_DECAY)
    texts = first
    target = torch.zeros(64, device="cuda")

    def an_step():
        ids, mask = an._embedder.tokenize(texts)
        an_opt.zero_grad(set_to_none=True)
        loss = NA.distill_loss(an.params, head, torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda(),
                               target, target)
        loss.backward(inputs=list(head.values()))
        an_opt.step()
        return loss.item()

    log(f"profile phase19 reranker step: {profile_calls(rr_step, 5, 1, 'step')} [{card}]")
    log(f"profile phase19 analyzer step: {profile_calls(an_step, 5, 1, 'step')} [{card}]")
    del rr, opt, an, an_opt
    free_device()


def item12_search(prefix, ck, docs, syn, card) -> dict:
    """19.2: ``search --rerank`` through the CLI on 256 strings (128
    synonym-flipped) over phase 18's index, with ``--kernel`` auto (kernel
    A) and pallas (kernel B): each result equal to ``rerank_search_result``
    over the un-reranked CLI search of the same strings (near-tie rule),
    each reranked top-10 a permutation of the first stage's; the first
    stage, the reranker and its card forward timed apart. Returns each
    kernel's launches."""
    from openintel_tpu_torch.models import reranker as RR

    rng = np.random.default_rng(191)
    strings = (encoder_queries(docs, syn, rng, BATCH // 2, 1.0)[0]
               + encoder_queries(docs, syn, rng, BATCH // 2, 0.0)[0])
    base = ["search", *strings, "--index", prefix, "--encoder", ck, "--format", "json", "-k", str(K)]
    rr = RR.load_reranker(ck)
    launches = {}
    for kernel, counter in (("auto", "i8_top2g"), ("pallas", "fused_topk")):
        first, counts = counted(lambda: cli_json(base + ["--kernel", kernel]))
        expect_launches(counts, **{counter: 1})
        # launches of the calls with and without --rerank
        times, first_s, rerank_s, score_s, load_s, n = [], [], [], [], [], counts[counter]
        for _ in range(ENC_REPS):
            with contextlib.ExitStack() as stack:
                stack.enter_context(timing(HybridRetriever, "search", first_s))
                stack.enter_context(timing(RR.CrossEncoderReranker, "rerank", rerank_s))
                stack.enter_context(timing(RR.CrossEncoderReranker, "score_pairs", score_s))
                stack.enter_context(timing(RR, "load_reranker", load_s))
                t0 = time.perf_counter()
                payload, counts = counted(lambda: cli_json(base + ["--kernel", kernel, "--rerank", ck]))
                times.append(time.perf_counter() - t0)
            expect_launches(counts, **{counter: 1})
            n += counts[counter]
        launches[counter] = n
        vals0, ids0 = hit_arrays(first)
        want = rerank_search_result(rr, strings, SearchResult(ids=ids0, scores=vals0), docs)
        vals, ids = hit_arrays(payload)
        swaps = near_tie_check(vals, ids, want.scores, want.ids, atol=TIE)
        for got_row, first_row in zip(ids, ids0):
            if sorted(got_row.tolist()) != sorted(first_row.tolist()):
                raise AssertionError("the reranked top-10 is not a permutation of the first stage's")
        moved = float((ids != ids0).any(axis=1).mean())
        pair_ids, pair_mask = rr.encode_pairs(strings, [[docs[d] for d in row if d >= 0] for row in ids0])
        fwd_ms = statistics.median(synced_ms(lambda: rr.score_pairs(pair_ids, pair_mask)) for _ in range(ENC_REPS))
        log(
            f"phase19 cli search --rerank --kernel {kernel}: {BATCH} strings ({BATCH // 2} mismatch) "
            f"in {statistics.median(times):.2f} s a process call (median of {ENC_REPS}): the first "
            f"stage (HybridRetriever.search) {statistics.median(first_s) * 1e3:.1f} ms, loading the "
            f"reranker {statistics.median(load_s) * 1e3:.1f} ms, the rerank "
            f"{statistics.median(rerank_s) * 1e3:.1f} ms (of it the card's forward over "
            f"{pair_ids.shape[0]} pairs of width {pair_ids.shape[1]} "
            f"{statistics.median(score_s) * 1e3:.1f} ms, alone {fwd_ms:.1f} ms; pair encoding and "
            f"the blend on the host the rest); json equal to rerank_search_result over the "
            f"un-reranked search ({swaps} near-tie swaps), each top-{K} a permutation of the first "
            f"stage's, {moved:.3f} of the rows reordered; {counter} launches 1 a call [{card}]"
        )
    del rr
    free_device()
    return launches


def item12_pairs(ck, docs, card) -> None:
    """19.3: 512 pairs scored by the reranker on the card and on the CPU,
    from the same weights: f32 within 1e-5, a bf16 config within 2e-2."""
    from openintel_tpu_torch.models import reranker as RR

    host = RR.load_reranker(ck, device="cpu")
    queries = [" ".join(d.split()[:3]) for d in docs[: RR_PAIRS // 8]]
    cands = [docs[1000 + 8 * i : 1008 + 8 * i] for i in range(RR_PAIRS // 8)]
    ids, mask = host.encode_pairs(queries, cands)
    errs, ms = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(host.cfg, dtype=dtype)
        tree = convert.encoder_tree(host.params)
        on = {dev: RR.CrossEncoderReranker(cfg, params=convert.encoder_params(tree, cfg), head=host.head, device=dev)
              for dev in ("cuda", "cpu")}
        got = on["cuda"].score_pairs(ids, mask)
        errs[dtype] = float(np.abs(got - on["cpu"].score_pairs(ids, mask)).max())
        ms[dtype] = statistics.median(synced_ms(lambda: on["cuda"].score_pairs(ids, mask)) for _ in range(ENC_REPS))
    if errs["float32"] > ENC_TOL or errs["bfloat16"] > ENC_BF16_TOL:
        raise AssertionError(f"the card's pair scores differ from the CPU's: {errs}")
    log(
        f"phase19 reranker on the card against the CPU: {ids.shape[0]} pairs of width {ids.shape[1]}, "
        f"same weights: f32 max abs err {errs['float32']:.3g} (<= {ENC_TOL}), bf16 config "
        f"{errs['bfloat16']:.3g} (<= {ENC_BF16_TOL}); on the card {ms['float32']:.2f} ms f32, "
        f"{ms['bfloat16']:.2f} ms bf16 (median of {ENC_REPS}, copies included) [{card}]"
    )


def item12_mcp(prefix, ck, docs, syn, card) -> dict:
    """19.4: ``build_server(index, encoder, rerank)``: 8 callers x 64
    strings through ``search_corpus``, each response held to a direct
    rerank of a direct search; then the live corpus with the reranker: 64
    docs added, 1 % deleted, 256 strings equal to the reranked plain
    route. Returns kernel A's launches."""
    def make_strings(rng, n):
        return encoder_queries(docs, syn, rng, n, ENC_FLIP)[0]

    server = build_server(index=prefix, encoder=ck, rerank=ck)
    if server.reranker is None:
        raise AssertionError("build_server loaded no reranker")
    rng = np.random.default_rng(194)
    tool(server, "search_corpus", {"queries": make_strings(rng, 4)})  # warm
    a_mcp = mcp_callers(
        server, {}, [None] * CALLERS, card, "the encoder index, reranked", make_strings=make_strings,
        seconds=ENC_CALL_S, phase="phase19",
    )
    del server
    free_device()
    server = build_server(index=prefix, encoder=ck, rerank=ck, updatable=True)
    upd = server.retriever
    tool(server, "index_documents", {"texts": synthetic_synonym_corpus(64, n_concepts=ENC_CONCEPTS, seed=194)[0]})
    n_total = ENC_DOCS + 64
    tool(server, "delete_documents", {"ids": sorted(rng.choice(n_total, n_total // 100, replace=False).tolist())})
    strings = make_strings(rng, BATCH)
    got, counts = counted(lambda: tool(server, "search_corpus", {"queries": strings, "k": K}))
    expect_launches(counts, i8_top2g=1)
    if not got["summary"].endswith(", cross-encoder reranked)"):
        raise AssertionError(f"summary {got['summary']!r}")
    want = rerank_search_result(
        server.reranker, strings, upd.search(strings, plain=True, k=K, candidates_per_arm=2 * K), upd.docs
    )
    vals, ids = hit_arrays(got["results"])
    swaps = near_tie_check(vals, ids, want.scores, want.ids, atol=TIE)
    if not upd._st.alive[ids[ids >= 0]].all():
        raise AssertionError("a deleted id came back")
    log(
        f"phase19 updatable --rerank: 64 docs added, 1 % deleted; {BATCH} strings through "
        f"search_corpus equal to rerank_search_result over the plain route ({swaps} near-tie "
        f"swaps), no deleted id, kernel A launches 1 [{card}]"
    )
    del server, upd
    free_device()
    return {"mcp_rerank": a_mcp, "updatable_rerank": counts["i8_top2g"]}


def item12_evaluate(docs, ck, tmp, card) -> int:
    """19.5: ``evaluate --encoder --rerank`` through the CLI on the first
    20,000 docs with 512 self-labelled queries (kernel B below 100k docs):
    the four rows printed, no limit on quality. Returns B's launches."""
    path = f"{tmp}/eval.txt"
    with open(path, "w") as f:
        f.write("\n".join(docs[:EVAL_DOCS]) + "\n")
    t0 = time.perf_counter()
    rows, counts = counted(lambda: cli_json([
        "evaluate", path, "--encoder", ck, "--rerank", ck, "--n-synthetic", str(EVAL_QUERIES), "--format", "json",
    ]))
    secs = time.perf_counter() - t0
    if [r["mode"] for r in rows] != ["bm25", "dense", "hybrid", "rerank"]:
        raise AssertionError(f"evaluate rows {rows}")
    for r in rows:
        if r["n_queries"] != EVAL_QUERIES or not all(0.0 <= r[m] <= 1.0 for m in ("recall_at_k", "mrr_at_k")):
            raise AssertionError(f"evaluate row {r}")
    if counts["fused_topk"] < 1:
        raise AssertionError(f"kernel B did not launch: {counts}")
    expect_launches(counts, fused_topk=counts["fused_topk"])
    table = "; ".join(f"{r['mode']} recall@{r['k']} {r['recall_at_k']:.4f} MRR {r['mrr_at_k']:.4f}" for r in rows)
    log(
        f"phase19 cli evaluate --encoder --rerank: {EVAL_DOCS} docs, {EVAL_QUERIES} self-labelled "
        f"queries (no flips) in {secs:.2f} s: {table} (no limit: {RR_STEPS} reranker steps); "
        f"fused_topk launches {counts['fused_topk']} [{card}]"
    )
    return counts["fused_topk"]


def lexicon_posts(docs, n, seed) -> list:
    """``n`` posts mixing the lexicon's terms with the corpus's words."""
    from openintel_tpu_torch.models import lexicon as L

    rng = np.random.default_rng(seed)
    words = list(L.BULL_TERMS + L.BEAR_TERMS + L.JARGON_TERMS) + docs[0].split() + docs[1].split()
    return [" ".join(rng.choice(words, size=int(rng.integers(0, 16))).tolist()) for _ in range(n)]


def item12_lexicon(posts, card) -> None:
    """19.6: the lexicon's device path at 100,000 posts and at exactly 512
    (``score_texts``' threshold) bit for bit its NumPy twin."""
    from openintel_tpu_torch.models import lexicon as L
    from openintel_tpu_torch.ops.tokenizer import encode_padded, tokenize_batch

    t0 = time.perf_counter()
    ids, mask = encode_padded(tokenize_batch(posts), L._LEX_VOCAB)
    host_s = time.perf_counter() - t0
    for n in (len(posts), L.DEVICE_BATCH_THRESHOLD):
        pol, spec = L.score_token_ids(ids[:n], mask[:n], L._LEX_FLAGS)
        want_p, want_s = L.score_token_ids_np(ids[:n], mask[:n], L._LEX_FLAGS)
        if not (np.array_equal(pol.cpu().numpy().view(np.uint32), want_p.astype(np.float32).view(np.uint32))
                and np.array_equal(spec.cpu().numpy(), want_s)):
            raise AssertionError(f"the lexicon's device path differs from its twin at {n} posts")
    signals = L.score_texts(posts[: L.DEVICE_BATCH_THRESHOLD])
    want_p, want_s = L.score_token_ids_np(*encode_padded(tokenize_batch(posts[:512]), L._LEX_VOCAB), L._LEX_FLAGS)
    if [(s.polarity.value, s.speculative) for s in signals] != [(float(p), bool(s)) for p, s in zip(want_p, want_s)]:
        raise AssertionError("score_texts at 512 posts differs from its twin")
    dev_ms = statistics.median(synced_ms(lambda: L.score_token_ids(ids, mask, L._LEX_FLAGS)) for _ in range(ENC_REPS))
    np_ms = statistics.median(synced_ms(lambda: L.score_token_ids_np(ids, mask, L._LEX_FLAGS)) for _ in range(ENC_REPS))
    log(
        f"phase19 lexicon: {len(posts)} posts ({ids.shape[1]} wide) and 512 on the card bit for bit "
        f"the NumPy twin; score_token_ids {dev_ms:.2f} ms on the card (copies included), the twin "
        f"{np_ms:.2f} ms on the host, tokenising and encoding {host_s:.2f} s (median of "
        f"{ENC_REPS}) [{card}]"
    )


def item12_analyzer(ck, posts, card) -> None:
    """19.7: the trained analyzer on 100,000 posts on the card against the
    port on the CPU, same weights: logits within 1e-5."""
    from openintel_tpu_torch.models.neural_analyzer import load_analyzer

    on_card, on_host = load_analyzer(ck), load_analyzer(ck, device="cpu")
    on_card.logits(posts[:64])  # warm
    t0 = time.perf_counter()
    got = on_card.logits(posts)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = on_host.logits(posts)
    host_s = time.perf_counter() - t0
    err = float(np.abs(got - want).max())
    if err > ENC_TOL:
        raise AssertionError(f"the analyzer's logits on the card differ by {err:.3g}")
    speculative = float((got[:, 1] > 0).mean())
    log(
        f"phase19 neural analyzer: {len(posts)} posts on the card against the port on the CPU, "
        f"same weights: logits max abs err {err:.3g} (<= {ENC_TOL}); {card_s:.2f} s on the card "
        f"({len(posts) / card_s:,.0f} posts a second, tokenising included), {host_s:.2f} s on the "
        f"CPU; {speculative:.3f} scored speculative [{card}]"
    )


def watchlist(rng, cfg):
    """WATCH_TICKERS tickers' (posts, signals, market), each of up to
    WATCH_SIGNALS signals, redrawn while its net sentiment or price move
    lies within GATE_MARGIN of an alignment gate (the f32 batch and the
    f64 scalar engine may round to either side there)."""
    from openintel_tpu_torch.domain.entities import MarketSnapshot, PostText, SocialPost, Ticker
    from openintel_tpu_torch.domain.values import PostSignal, SourceKind

    text = PostText.parse("post")
    out = []
    while len(out) < WATCH_TICKERS:
        ticker = Ticker.parse("T" + "ABCDEFGHIJKLMNOPQRSTUVWXYZ"[len(out) % 26] * (1 + len(out) // 26))
        n = int(rng.integers(0, WATCH_SIGNALS + 1))
        pol = rng.uniform(-1.2, 1.2, n).astype(np.float32)
        spec = rng.random(n) < 0.3
        market = None
        if rng.random() < 0.8:
            market = MarketSnapshot(
                ticker=ticker, as_of=NOW, last_price=float(np.float32(rng.uniform(50, 250))),
                previous_close=float(rng.choice([0.0, 100.0, 185.0])), volume=int(rng.integers(0, 10**8)),
                avg_volume=int(rng.choice([0, 52_000_000])),
                iv_rank=float(np.float32(rng.uniform(0, 1))) if rng.random() < 0.5 else None,
            )
        net = float(np.clip(pol.astype(np.float64), -1, 1).mean()) if n else 0.0
        gates = [abs(net) - cfg.net_sentiment_threshold, net] if n else [1.0]
        if market is not None and market.previous_close:
            pct = (market.last_price - market.previous_close) / market.previous_close * 100
            gates += [abs(pct) - cfg.price_move_threshold, pct]
        if min(abs(g) for g in gates) <= GATE_MARGIN:
            continue
        kinds = (SourceKind.REDDIT, SourceKind.BLUESKY)
        posts = [SocialPost(id=str(j), source=kinds[j % 2], author="a", text=text, created_at=NOW, engagement=j)
                 for j in range(n)]
        signals = [PostSignal.of(float(p), bool(s)) for p, s in zip(pol, spec)]
        out.append((ticker, posts, signals, market))
    return out


def item12_engine(card) -> None:
    """19.8: ``analyze_batch`` over a watchlist of 64 tickers x up to 2,000
    signals (in-script sources and analyzer), aggregated on the card, each
    report held to the scalar ``SpeculationEngine``, the columns to the
    port's CPU run; then ``aggregate_batch`` at 1,024 x 1,024 (NaN
    polarity, absent markets, zero closes and volumes) against the CPU
    and timed."""
    from openintel_tpu_torch.application.analyze import analyze_batch
    from openintel_tpu_torch.application.request import AnalysisRequest
    from openintel_tpu_torch.domain import engine_batch as EB
    from openintel_tpu_torch.domain.engine import EngineConfig, SpeculationEngine
    from openintel_tpu_torch.domain.values import SourceKind

    cfg = EngineConfig()
    cases = watchlist(np.random.default_rng(198), cfg)
    by_symbol = {t.as_str(): (posts, signals, market) for t, posts, signals, market in cases}
    by_post = {}

    class Social:
        kind = SourceKind.REDDIT

        async def fetch(self, ticker, limit):
            posts = by_symbol[ticker.as_str()][0]
            by_post.update((id(p), s) for p, s in zip(posts, by_symbol[ticker.as_str()][1]))
            return posts

    class Market:
        name = "script-market"

        async def snapshot(self, ticker):
            market = by_symbol[ticker.as_str()][2]
            if market is None:
                raise RuntimeError("no quote")
            return market

    class Signals:
        async def analyze(self, posts):
            return [by_post[id(p)] for p in posts]

    reqs = [AnalysisRequest(ticker=t.as_str(), enabled_sources=(SourceKind.REDDIT,), limit=WATCH_SIGNALS)
            for t, *_ in cases]
    t0 = time.perf_counter()
    reports = asyncio.run(analyze_batch(reqs, [Social()], Market(), Signals(), now=NOW))
    batch_s = time.perf_counter() - t0
    checked = 0
    for (ticker, posts, signals, market), got in zip(cases, reports):
        if isinstance(got, Exception):
            raise AssertionError(f"{ticker.as_str()}: {got}")
        want = SpeculationEngine.aggregate(ticker, posts, signals, market, NOW, cfg)
        notes = ([] if market is not None else ["market source failed: no quote"]) + want.fusion.notes
        g, w = got.to_dict(), want.to_dict()
        w["fusion"]["notes"] = notes
        for key in ("social", "fusion", "market"):
            if (g[key] is None) != (w[key] is None):
                raise AssertionError(f"{ticker.as_str()}: {key} present on one side only")
            for f, wv in (w[key] or {}).items():
                gv = g[key][f]
                same = (abs(gv - wv) <= SCALAR_TOL * max(1.0, abs(wv)) if isinstance(wv, float) and gv is not None
                        else gv == wv)
                if not same:
                    raise AssertionError(f"{ticker.as_str()} {key}.{f}: {gv} != {wv}")
                checked += 1
        if g["social_confidence"] != w["social_confidence"]:
            raise AssertionError(f"{ticker.as_str()}: confidence")
    inputs = [(posts, signals, market) for _, posts, signals, market in cases]
    card_cols = EB.aggregate_batch(*EB.pack_batch(inputs), cfg)
    host_cols = EB.aggregate_batch(*EB.pack_batch(inputs, device="cpu"), cfg)
    check_engine_columns(card_cols, host_cols)
    n_signals = sum(len(s) for _, s, _ in inputs)
    log(
        f"phase19 analyze_batch: {WATCH_TICKERS} tickers x up to {WATCH_SIGNALS} signals "
        f"({n_signals} in all) aggregated on the card in {batch_s:.2f} s (fetch, pack, one "
        f"aggregate_batch, reports); every report equal to the scalar SpeculationEngine's "
        f"({checked} fields; floats within {SCALAR_TOL} relative), the columns to the CPU run's "
        f"(integers and codes equal, floats within {ENGINE_TOL}) [{card}]"
    )
    rng = np.random.default_rng(199)
    arrays = dict(
        polarity=np.where(rng.random((BIG_B, BIG_N)) < 0.05, np.nan, rng.uniform(-1.3, 1.3, (BIG_B, BIG_N))).astype(np.float32),
        speculative=rng.random((BIG_B, BIG_N)) < 0.3,
        valid=np.arange(BIG_N)[None, :] < rng.integers(0, BIG_N + 1, BIG_B)[:, None],
        present=rng.random(BIG_B) < 0.8, last_price=rng.uniform(50, 250, BIG_B).astype(np.float32),
        previous_close=rng.choice([0.0, 100.0, 185.0], BIG_B).astype(np.float32),
        volume=rng.uniform(0, 1e8, BIG_B).astype(np.float32),
        avg_volume=rng.choice([0.0, 0.5, 5.2e7], BIG_B).astype(np.float32),
        iv_rank=rng.uniform(0, 1, BIG_B).astype(np.float32), iv_present=rng.random(BIG_B) < 0.5,
    )

    def batch_on(device):
        def split(cls):
            return cls(**{f.name: torch.from_numpy(arrays[f.name]).to(device) for f in dataclasses.fields(cls)})

        return split(EB.BatchSignals), split(EB.BatchMarket)

    sig, mkt = batch_on("cuda")
    check_engine_columns(EB.aggregate_batch(sig, mkt, cfg), EB.aggregate_batch(*batch_on("cpu"), cfg))
    ms = cuda_ms(lambda: EB.aggregate_batch(sig, mkt, cfg), 20, warmup=2)
    host_ms = statistics.median(synced_ms(lambda: EB.aggregate_batch(*batch_on("cpu"), cfg)) for _ in range(3))
    log(
        f"phase19 aggregate_batch at {BIG_B} x {BIG_N} ({BIG_B * BIG_N:,} elements; 5 % NaN "
        f"polarity, absent markets, zero closes and volumes): the card's columns equal to the "
        f"CPU run's by the rule above; {ms:.4f} ms on the card (events, 20 calls, torch ops), "
        f"the CPU run {host_ms:.2f} ms [{card}]"
    )


def check_engine_columns(got, want) -> None:
    for name in ("total_mentions", "bullish", "bearish", "neutral", "alignment", "confidence"):
        if not torch.equal(getattr(got, name).cpu(), getattr(want, name).cpu()):
            raise AssertionError(f"aggregate_batch's {name} differs on the card")
    for name in ("net_sentiment", "speculation_index", "pct_change", "rvol", "crowding"):
        g, w = getattr(got, name).cpu().numpy(), getattr(want, name).cpu().numpy()
        if not np.allclose(g, w, rtol=ENGINE_TOL, atol=ENGINE_TOL, equal_nan=True):
            raise AssertionError(f"aggregate_batch's {name} differs on the card")


def item12_atr(card) -> None:
    """19.9: ``atr_batch`` over 512 tickers x 250 bars on the card against
    the CPU run (1e-6) and the scalar ``atr`` of each ticker (1e-5
    relative), and ``risk_screen`` on the card over the same bars."""
    from openintel_tpu_torch.application.risk import risk_frame, risk_screen
    from openintel_tpu_torch.domain.risk import atr, atr_batch
    from openintel_tpu_torch.domain.values import Bar

    rng = np.random.default_rng(200)
    close = np.maximum(100 + np.cumsum(rng.normal(0, 2, (ATR_TICKERS, ATR_BARS)), axis=1), 5.0).astype(np.float32)
    high = (close + np.abs(rng.normal(0, 1, close.shape)) + 0.5).astype(np.float32)
    low = np.maximum(close - np.abs(rng.normal(0, 1, close.shape)) - 0.5, 1.0).astype(np.float32)
    on_card = [torch.from_numpy(a).cuda() for a in (high, low, close)]
    got = atr_batch(*on_card).cpu().numpy()
    host = atr_batch(*map(torch.from_numpy, (high, low, close))).numpy()
    bars = [[Bar(float(h), float(l), float(c)) for h, l, c in zip(*rows)] for rows in zip(high, low, close)]
    scalar = np.array([atr(b, 14) for b in bars])
    if not np.allclose(got, host, rtol=ENGINE_TOL, atol=0) or not np.allclose(got, scalar, rtol=SCALAR_TOL, atol=0):
        raise AssertionError("atr_batch on the card differs")
    ms = cuda_ms(lambda: atr_batch(*on_card), 20, warmup=2)
    source = BarsByLetters(bars)
    t0 = time.perf_counter()
    frames = asyncio.run(risk_screen([letters(i) for i in range(ATR_TICKERS)], "long", 500.0, 2.0, source, NOW))
    screen_s = time.perf_counter() - t0
    for i in (0, ATR_TICKERS // 3, ATR_TICKERS - 1):
        want = asyncio.run(risk_frame(letters(i), "long", 500.0, 2.0, None, source, NOW))
        if abs(frames[i].atr - want.atr) > SCALAR_TOL * want.atr or frames[i].shares != want.shares:
            raise AssertionError(f"risk_screen's frame {i} differs from risk_frame's")
    log(
        f"phase19 atr_batch: {ATR_TICKERS} tickers x {ATR_BARS} bars on the card equal to the CPU run "
        f"(rtol {ENGINE_TOL}) and the scalar atr (rtol {SCALAR_TOL}); {ms:.4f} ms on the card "
        f"(events, 20 calls); risk_screen over the {ATR_TICKERS} tickers {screen_s * 1e3:.1f} ms "
        f"(its ATR on the card), frames equal to risk_frame's [{card}]"
    )


def letters(i: int) -> str:
    """A ticker symbol for index ``i`` ("R" and its digits as letters)."""
    return "R" + "".join("ABCDEFGHIJ"[int(c)] for c in str(i))


class BarsByLetters:
    """A bar source over ``bars``, by the index a symbol of ``letters``
    spells."""

    def __init__(self, bars):
        self.history = bars

    async def bars(self, ticker):
        return self.history[int("".join(str("ABCDEFGHIJ".index(c)) for c in ticker.as_str()[1:]))]


def phase_item12(card, state, tmp) -> dict:
    """Phase 19: ROADMAP item 12 on phase 18's corpus, checkpoint and
    index. Returns kernel A's and B's launches in it."""
    docs, syn, ck, prefix = state["docs"], state["syn"], state["ck"], state["prefix"]
    item12_train(state["path"], syn, ck, tmp, card)
    launches = item12_search(prefix, ck, docs, syn, card)
    item12_pairs(ck, docs, card)
    mcp = item12_mcp(prefix, ck, docs, syn, card)
    b_eval = item12_evaluate(docs, ck, tmp, card)
    posts = lexicon_posts(docs, LEX_POSTS, seed=196)
    item12_lexicon(posts, card)
    item12_analyzer(ck, posts, card)
    item12_engine(card)
    item12_atr(card)
    free_device()
    return {
        "i8_top2g": {"item12_launches": {"cli_search_rerank": launches["i8_top2g"], **mcp}},
        "fused_topk": {"item12_launches": {"cli_search_rerank": launches["fused_topk"], "evaluate": b_eval}},
    }


# ---------------------------------------------------------------------------
# Phase 20: ROADMAP item 14, the analysis surface
# ---------------------------------------------------------------------------

# on phase 18's index and checkpoint and phase 19's analyzer head
WATCH100, WATCH100_LIMIT = 100, 50  # scan_watchlist at the CLI's default limit: 100 posts a ticker
WATCH16, WATCH16_LIMIT = 16, 300  # 600 posts a ticker: the lexicon's card path
RISK_TICKERS = 512  # risk over a list: one atr_batch on the card
CLI_AT_ONCE = 4  # CLI subprocesses run together (each pays ~6 s of start-up on the card's host)
SCANNERS = 2  # 20.4: callers looping scan_watchlist beside the search_corpus callers
ITEM14_CALL_S = 3.0  # 20.4: seconds of each run of search_corpus callers
JSON_TOL = 1e-6  # the card against --device cpu: floats of a JSON result (f32 aggregation)
CRED_ENV = ("OPENINTEL_REDDIT_CLIENT_ID", "OPENINTEL_REDDIT_CLIENT_SECRET", "OPENINTEL_BLUESKY_HANDLE",
            "OPENINTEL_BLUESKY_APP_PASSWORD", "OPENINTEL_MARKET_API_KEY", "OPENINTEL_X_BEARER")
ANALYSIS_TOOLS = ["list_sources", "analyze_ticker", "scan_watchlist", "compare_tickers", "x_pulse", "risk_frame"]
RANK_BY = ("crowding", "speculation_index", "net_sentiment", "divergence")
_CHILD = (
    "import sys, time\n"
    "import torch\n"
    "from openintel_tpu_torch.cli.main import main\n"
    "t = time.time()\n"
    "code = main(sys.argv[1:])\n"
    "sys.stdout.flush()\n"
    "print(f'\\nOI_MAIN {t!r} {time.time() - t!r}', file=sys.stderr)\n"
    "sys.exit(code)\n"
)


def child_env() -> dict:
    """The environment of a CLI subprocess: the checkout on the path, no
    credentials (nothing is fetched)."""
    env = {k: v for k, v in os.environ.items() if k not in CRED_ENV}
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    return env


def cli_call(argv) -> tuple[int, str, float, float]:
    """The port's CLI as a subprocess (``main(argv)``, as ``python -m
    openintel_tpu_torch.cli.main`` runs it): (exit code, stdout, start-up
    s, work s). Start-up is the interpreter, ``import torch`` (which every
    command pays) and the CLI's module, up to ``main``; work is ``main``
    (the card's context included where the command uses the card)."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, *argv], capture_output=True, text=True, timeout=300,
        env=child_env(), cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    mark = [ln.split() for ln in proc.stderr.splitlines() if ln.startswith("OI_MAIN ")]
    if not mark:
        raise AssertionError(f"cli {argv[:2]} died: {proc.stderr[-2000:]}")
    return proc.returncode, proc.stdout, float(mark[-1][1]) - t0, float(mark[-1][2])


def cli_calls(argvs) -> list:
    """``cli_call`` of each argv, CLI_AT_ONCE at a time, in the order
    given."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(CLI_AT_ONCE) as pool:
        return list(pool.map(cli_call, argvs))


def cli_cpu(argv) -> tuple[int, str]:
    """The same call in this process with ``--device cpu``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli_main([*argv, "--device", "cpu"])
    return code, out.getvalue()


def drop_clock(obj):
    if isinstance(obj, dict):
        return {k: drop_clock(v) for k, v in obj.items() if k != "generated_at"}
    if isinstance(obj, list):
        return [drop_clock(v) for v in obj]
    return obj


def json_close(got, want, tol=JSON_TOL, where="$") -> None:
    """Integers, strings and codes equal, floats within ``tol``; the
    ``generated_at`` clock fields are dropped by the caller."""
    if isinstance(want, float) or isinstance(got, float):
        if not (isinstance(got, (int, float)) and isinstance(want, (int, float)) and abs(got - want) <= tol):
            raise AssertionError(f"{where}: {got} != {want}")
    elif isinstance(want, dict):
        if not isinstance(got, dict) or list(got) != list(want):
            raise AssertionError(f"{where}: keys {list(got)} != {list(want)}")
        for k in want:
            json_close(got[k], want[k], tol, f"{where}.{k}")
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{where}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            json_close(g, w, tol, f"{where}[{i}]")
    elif got != want:
        raise AssertionError(f"{where}: {got!r} != {want!r}")


def item14_doctor(prefix, card) -> None:
    """20.1: ``doctor`` and ``doctor --index PREFIX`` as subprocesses: exit
    0, ``status: ok``, the card named, the CUDA kernel library built and
    current (phase 1 built it), the index valid."""
    name = torch.cuda.get_device_name(0)
    so = _kernels.library_path().name
    argvs = (["doctor"], ["doctor", "--index", prefix])
    results = cli_calls(argvs)
    for argv, (code, out, _, _) in zip(argvs, results):
        want = ["status: ok", name, f"CUDA kernels: built and current ({so})", "native tier: C++"]
        if len(argv) > 1:
            want.append(f"{ENC_DOCS} docs")
        missing = [w for w in want if w not in out]
        if code != 0 or missing:
            raise AssertionError(f"doctor {argv[1:]}: exit {code}, missing {missing}: {out[-1500:]}")
    log(
        "phase20 cli doctor, doctor --index (subprocesses, together): status ok, the card and "
        f"the kernel library named; start-up/work {results[0][2]:.2f}/{results[0][3]:.2f} s and "
        f"{results[1][2]:.2f}/{results[1][3]:.2f} s [{card}]"
    )


def item14_cli(ck, card) -> None:
    """20.2: the offline analysis commands as subprocesses on the card,
    each JSON equal to the same call with ``--device cpu`` (floats within
    1e-6; the analyzer's within ENC_TOL), the reference's goldens held,
    and each call's start-up and work logged."""
    tickers = [letters(i) for i in range(RISK_TICKERS)]
    calls = [
        ("analyze", ["analyze", "AAPL", "--offline", "--format", "json"], JSON_TOL),
        ("analyze --analyzer", ["analyze", "AAPL", "--offline", "--analyzer", ck, "--format", "json"], ENC_TOL),
        ("scan", ["scan", "AAPL", "TSLA", "MSFT", "$$$", "--offline", "--format", "json"], JSON_TOL),
        *((f"compare {r}", ["compare", "AAPL", "TSLA", "MSFT", "$$$", "--offline", "--rank-by", r,
                            "--format", "json"], JSON_TOL) for r in RANK_BY),
        ("risk", ["risk", "NVDA", "--budget", "200", "--offline", "--format", "json"], JSON_TOL),
        (f"risk x{RISK_TICKERS}", ["risk", *tickers, "--budget", "200", "--offline", "--format", "json"],
         JSON_TOL),
    ]
    table, pulse = ["analyze", "AAPL", "--offline"], ["pulse", "AAPL"]
    results = cli_calls([argv for _, argv, _ in calls] + [table, pulse])
    docs = []
    for (_, argv, tol), (code, out, _, _) in zip(calls, results):
        code_cpu, out_cpu = cli_cpu(argv)
        if code != 0 or code_cpu != 0:
            raise AssertionError(f"{argv[:2]}: exit {code} (card), {code_cpu} (cpu): {out[-500:]}")
        doc = json.loads(out)
        json_close(drop_clock(doc), drop_clock(json.loads(out_cpu)), tol)
        docs.append(doc)
    code, out, _, _ = results[-2]
    if code != 0 or out.splitlines()[2:] != cli_cpu(table)[1].splitlines()[2:]:
        raise AssertionError("analyze's table on the card differs from --device cpu's")
    analyze, _, scan = docs[:3]
    risk, screen = docs[-2], docs[-1]
    goldens = {
        "mentions": analyze["social"]["total_mentions"] == 10,
        "crowding": abs(analyze["fusion"]["crowding"] - 0.49669) < 1e-3,
        "alignment": analyze["fusion"]["alignment"] == "confirming_bullish",
        "scan": [e.get("error", "")[:14] for e in scan["entries"]] == ["", "", "", "invalid ticker"],
        "atr": abs(risk["atr"] - 4.0) < 1e-9 and risk["shares"] == 25,
        "screen": len(screen) == RISK_TICKERS and all(abs(f["atr"] - 4.0) < 1e-5 and f["shares"] == 25
                                                       for f in screen),
    }
    if not all(goldens.values()):
        raise AssertionError(f"goldens missed: {[k for k, v in goldens.items() if not v]}")
    code, out, _, _ = results[-1]
    want = "x pulse is not configured — set OPENINTEL_X_BEARER or run `openintel setup x`\n"
    if code != 1 or out != want:
        raise AssertionError(f"pulse without a bearer: exit {code}, {out!r}")
    per = "; ".join(
        f"{label} {s:.2f}/{w:.2f}"
        for label, (_, _, s, w) in zip([c[0] for c in calls] + ["analyze table", "pulse"], results)
    )
    log(
        f"phase20 cli analyze (json, table, --analyzer), scan, compare x4 rank_by, risk (1 and "
        f"{RISK_TICKERS} tickers), pulse without a bearer (exit 1, the reference's text), each a "
        f"subprocess on the card, {CLI_AT_ONCE} at a time: JSON equal to --device cpu (floats "
        f"within {JSON_TOL}, the analyzer's within {ENC_TOL}), goldens held (10 mentions, crowding 0.49669, ATR 4.0, 25 "
        f"shares); start-up/work s: {per} [{card}]"
    )


class ScriptFeed:
    """Posts for the analysis tools: each source gives ``limit`` posts of
    the lexicon's terms and the corpus's words, drawn from a seed of the
    source, the ticker and the limit. A ticker whose net sentiment lies
    within GATE_MARGIN of the alignment gate is drawn again (the f32 batch
    and the f64 scalar engine may round to either side there)."""

    def __init__(self, docs):
        from openintel_tpu_torch.models import lexicon as L

        self.words = list(L.BULL_TERMS + L.BEAR_TERMS + L.JARGON_TERMS) + docs[0].split() + docs[1].split()
        self.posts = {}  # (kind, ticker, limit) -> posts

    def draw(self, kind, ticker, limit, attempt):
        from openintel_tpu_torch.domain.entities import PostText, SocialPost

        seed = [ord(c) for c in f"{kind.value}:{ticker}:{limit}:{attempt}"]
        rng = np.random.default_rng(seed)
        return [
            SocialPost(id=f"{kind.value}-{ticker}-{j}", source=kind, author=f"a{j % 17}",
                       text=PostText.parse(" ".join(rng.choice(self.words, size=int(rng.integers(1, 16))))),
                       created_at=NOW, engagement=int(rng.integers(0, 500)))
            for j in range(limit)
        ]

    def prepare(self, tickers, limit, cfg):
        from openintel_tpu_torch.domain.values import SourceKind
        from openintel_tpu_torch.models.lexicon import score_texts

        for ticker in tickers:
            for attempt in range(100):
                drawn = {k: self.draw(k, ticker, limit, attempt) for k in (SourceKind.REDDIT, SourceKind.BLUESKY)}
                posts = [p for k in drawn for p in drawn[k]]
                pol = [s.polarity.value for s in score_texts([p.text.as_str() for p in posts], device="cpu")]
                net = sum(pol) / len(pol)
                if min(abs(abs(net) - cfg.net_sentiment_threshold), abs(net)) > GATE_MARGIN:
                    break
            self.posts.update(((k, ticker, limit), v) for k, v in drawn.items())



class ScriptSource:
    """A social source of ``kind`` over a ``ScriptFeed``'s posts."""

    def __init__(self, feed, kind):
        self.feed, self.kind = feed, kind

    async def fetch(self, ticker, limit):
        return self.feed.posts[(self.kind, ticker.as_str(), limit)]


class ScriptMarket:
    """A market source: each ticker's close 2-6 % from the previous one
    (clear of the 1 % price gate), its volume and IV rank from a seed of
    the ticker."""

    name = "script-market"

    async def snapshot(self, ticker):
        from openintel_tpu_torch.domain.entities import MarketSnapshot

        rng = np.random.default_rng([ord(c) for c in ticker.as_str()])
        prev = float(np.float32(rng.uniform(20, 400)))
        move = float(rng.choice([-1, 1]) * rng.uniform(2, 6))
        return MarketSnapshot(
            ticker=ticker, as_of=NOW, last_price=float(np.float32(prev * (1 + move / 100))),
            previous_close=prev, volume=int(rng.integers(10**6, 10**8)),
            avg_volume=int(rng.integers(10**6, 10**8)),
            iv_rank=float(np.float32(rng.uniform(0, 1))) if rng.random() < 0.7 else None,
        )


def watch_symbols(n, offset=0) -> list:
    return ["W" + letters(i)[1:] for i in range(offset, offset + n)]


@functools.cache
def scalar_report(feed, symbol, limit, market, batched) -> tuple:
    """The scalar ``SpeculationEngine``'s report for ``symbol`` over the
    feed's posts and the lexicon's signals on the host, and the number of
    posts whose polarity is exactly f32(+-tau). With ``batched``, those
    posts count as neutral, as the f32 batch counts them (the f64 engine
    counts them bullish or bearish)."""
    from openintel_tpu_torch.domain.engine import EngineConfig, SpeculationEngine
    from openintel_tpu_torch.domain.entities import Ticker
    from openintel_tpu_torch.domain.values import SourceKind
    from openintel_tpu_torch.models.lexicon import score_texts

    cfg = EngineConfig()
    ticker = Ticker.parse(symbol)
    posts = [p for k in (SourceKind.REDDIT, SourceKind.BLUESKY) for p in feed.posts[(k, symbol, limit)]]
    signals = score_texts([p.text.as_str() for p in posts], device="cpu")
    snap = asyncio.run(market.snapshot(ticker))
    want = SpeculationEngine.aggregate(ticker, posts, signals, snap, NOW, cfg).to_dict()
    tau = float(np.float32(cfg.bull_bear_threshold))
    up = sum(s.polarity.value == tau for s in signals)
    down = sum(s.polarity.value == -tau for s in signals)
    if not batched:
        return drop_clock(want), up + down
    social = want["social"]
    social["bullish"] -= up
    social["bearish"] -= down
    social["neutral"] += up + down
    social["bull_bear_ratio"] = None if not social["bearish"] else social["bullish"] / social["bearish"]
    return drop_clock(want), up + down


def check_scalar(got: dict, want: dict, symbol: str) -> int:
    """A report against the scalar engine's: floats within SCALAR_TOL
    relative, everything else equal. Returns the fields checked."""
    checked = 0
    for key in ("social", "fusion", "market"):
        if (got[key] is None) != (want[key] is None):
            raise AssertionError(f"{symbol}: {key} present on one side only")
        for f, wv in (want[key] or {}).items():
            gv = got[key][f]
            same = (abs(gv - wv) <= SCALAR_TOL * max(1.0, abs(wv)) if isinstance(wv, float) and gv is not None
                    else gv == wv)
            if not same:
                raise AssertionError(f"{symbol} {key}.{f}: {gv} != {wv}")
            checked += 1
    if got["social_confidence"] != want["social_confidence"]:
        raise AssertionError(f"{symbol}: confidence")
    return checked + 1


def item14_tools(docs, card) -> tuple:
    """20.3: the analysis tools in process, on a server over the script's
    sources: scan_watchlist over 100 tickers at limit 50 (the lexicon on
    the host per ticker, one aggregate_batch on the card) and over 16 at
    limit 300 (the lexicon on the card), compare_tickers under each
    rank_by, analyze_ticker, risk_frame and list_sources; each result equal
    to the same server's with ``device="cpu"`` and each report to the
    scalar engine's. Returns the feed and the market (20.4 scans them)."""
    from openintel_tpu_torch.domain.engine import EngineConfig
    from openintel_tpu_torch.domain.values import SourceKind
    from openintel_tpu_torch.mcp.server import OpenIntelServer
    from openintel_tpu_torch.sources.yahoo import FixtureBars

    t0 = time.perf_counter()
    feed, market = ScriptFeed(docs), ScriptMarket()
    small, big = watch_symbols(WATCH100), watch_symbols(WATCH16, WATCH100)
    feed.prepare(small, WATCH100_LIMIT, EngineConfig())
    feed.prepare(big, WATCH16_LIMIT, EngineConfig())
    log(f"setup phase20: {2 * (WATCH100 * WATCH100_LIMIT + WATCH16 * WATCH16_LIMIT)} posts drawn "
        f"({time.perf_counter() - t0:.1f}s)")
    social = [ScriptSource(feed, SourceKind.REDDIT), ScriptSource(feed, SourceKind.BLUESKY)]
    server = OpenIntelServer(social, market, bars=FixtureBars(), device="cuda")
    calls = [
        ("scan_watchlist", {"tickers": small}, WATCH100_LIMIT),
        ("scan_watchlist", {"tickers": big, "limit": WATCH16_LIMIT}, WATCH16_LIMIT),
        *(("compare_tickers", {"tickers": small, "rank_by": r}, WATCH100_LIMIT) for r in RANK_BY),
        ("analyze_ticker", {"ticker": big[0], "limit": WATCH16_LIMIT}, WATCH16_LIMIT),
        ("risk_frame", {"ticker": "NVDA", "budget_usd": 200.0}, None),
        ("list_sources", {}, None),
    ]
    tool(server, "scan_watchlist", {"tickers": small[:4]})  # warm
    lines, checked, boundary = [], 0, 0
    for name, args, limit in calls:
        server.device = "cuda"
        card_ms = synced_ms(lambda: tool(server, name, args))
        got = tool(server, name, args)
        server.device = "cpu"
        t = time.perf_counter()
        want = tool(server, name, args)
        cpu_ms = (time.perf_counter() - t) * 1e3
        json_close(drop_clock(got), drop_clock(want))
        reports = ([(e["ticker"], e["report"]) for e in got.get("entries", [])]
                   + [(e["ticker"], e["report"]) for e in got.get("ranked", [])]
                   + ([(args["ticker"], got["report"])] if name == "analyze_ticker" else []))
        for symbol, report in reports:
            want_report, n = scalar_report(feed, symbol, limit, market, name != "analyze_ticker")
            checked += check_scalar(report, want_report, symbol)
            boundary += n if name != "analyze_ticker" else 0
        lines.append(f"{name}{'' if 'rank_by' not in args else ' ' + args['rank_by']}"
                     f"{'' if 'tickers' not in args else ' x' + str(len(args['tickers']))} "
                     f"{card_ms:.1f}/{cpu_ms:.1f}")
    if got != {"social": ["reddit", "bluesky"], "market": ["script-market"]}:
        raise AssertionError(f"list_sources: {got}")
    log(
        f"phase20 mcp analysis tools in process over the script's sources (scan {WATCH100} x "
        f"{2 * WATCH100_LIMIT} posts: the lexicon on the host, one aggregate_batch on the card; "
        f"scan {WATCH16} x {2 * WATCH16_LIMIT}: the lexicon on the card): each result equal to "
        f"device=cpu's (floats within {JSON_TOL}), each report to the scalar SpeculationEngine's "
        f"({checked} fields, floats within {SCALAR_TOL} relative; {boundary} batched posts at "
        f"exactly f32(+-0.2) counted neutral, as the f32 batch counts them, and bullish or "
        f"bearish by analyze_ticker's scalar engine); ms card/cpu: "
        f"{'; '.join(lines)} [{card}]"
    )
    return feed, market, social, small


def item14_mixed(prefix, ck, docs, syn, scan, card) -> dict:
    """20.4: ``build_server(offline=True, index, encoder)`` on the card,
    its social and market sources swapped for the script's (the offline
    fixtures give 10 posts a ticker; the scans here give the CLI default's
    100): 8 search_corpus callers x 64 strings alone, then beside 2
    callers looping scan_watchlist over the 100 tickers on the same event
    loop. Each caller's responses held to a direct search (near-tie rule).
    Returns kernel A's launches in each run."""
    _, market, social, small = scan

    def make_strings(rng, n):
        return encoder_queries(docs, syn, rng, n, ENC_FLIP)[0]

    server = build_server(offline=True, index=prefix, encoder=ck)
    server.social, server.market = social, market
    tool(server, "search_corpus", {"queries": make_strings(np.random.default_rng(201), 4)})  # warm
    scan_ms = []

    async def scanner(stop):
        while time.perf_counter() < stop:
            msg = {"jsonrpc": "2.0", "id": 0, "method": "tools/call",
                   "params": {"name": "scan_watchlist", "arguments": {"tickers": small}}}
            t = time.perf_counter()
            resp = await server.handle(msg)
            if resp["result"]["isError"]:
                raise AssertionError(resp["result"]["content"][0]["text"])
            scan_ms.append((time.perf_counter() - t) * 1e3)
            await asyncio.sleep(0)

    alone, mixed = {}, {}
    a_alone = mcp_callers(server, {}, [None] * CALLERS, card, "alone", make_strings=make_strings,
                          seconds=ITEM14_CALL_S, phase="phase20", stats=alone)
    a_mixed = mcp_callers(server, {}, [None] * CALLERS, card, f"beside {SCANNERS} scan_watchlist loops",
                          make_strings=make_strings, seconds=ITEM14_CALL_S, phase="phase20",
                          background=[scanner] * SCANNERS, stats=mixed)
    log(
        f"phase20 mixed load: search_corpus {alone['qps']:.0f} q/s alone, {mixed['qps']:.0f} q/s "
        f"beside {SCANNERS} scan_watchlist loops ({len(scan_ms)} scans of {WATCH100} tickers, "
        f"p50 {np.percentile(scan_ms, 50):.1f} ms, p99 {np.percentile(scan_ms, 99):.1f} ms); "
        f"caller p50/p99 {alone['p50_ms']:.1f}/{alone['p99_ms']:.1f} ms alone, "
        f"{mixed['p50_ms']:.1f}/{mixed['p99_ms']:.1f} ms mixed; waves {alone['waves']} / "
        f"{mixed['waves']}; kernel A launches {a_alone} / {a_mixed} [{card}]"
    )
    del server
    free_device()
    return {"mcp_alone": a_alone, "mcp_beside_scans": a_mixed}


def item14_stdio(prefix, ck, card) -> None:
    """20.5: ``mcp --offline --index PREFIX --encoder CK`` as a subprocess
    over stdio on the card: initialize, tools/list (the reference's 8
    names, in its order) and one tools/call of each analysis tool, each
    result equal to an offline server's on the CPU in this process."""
    def call(rid, name, args):
        return {"jsonrpc": "2.0", "id": rid, "method": "tools/call",
                "params": {"name": name, "arguments": args}}

    args = {
        "list_sources": {}, "analyze_ticker": {"ticker": "AAPL"},
        "scan_watchlist": {"tickers": ["AAPL", "TSLA", "$$$"]},
        "compare_tickers": {"tickers": ["AAPL", "MSFT"], "rank_by": "divergence"},
        "x_pulse": {"ticker": "NVDA"}, "risk_frame": {"ticker": "NVDA", "budget_usd": 200.0},
    }
    lines = [{"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
             {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
             *(call(10 + i, n, args[n]) for i, n in enumerate(ANALYSIS_TOOLS))]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "openintel_tpu_torch.cli.main", "mcp", "--offline", "--index", prefix,
         "--encoder", ck],
        input="".join(json.dumps(m) + "\n" for m in lines), capture_output=True, text=True,
        timeout=300, env=child_env(), cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"mcp --offline exited {proc.returncode}: {proc.stderr[-2000:]}")
    by_id = {d["id"]: d for d in map(json.loads, proc.stdout.strip().splitlines())}
    names = [t["name"] for t in by_id[2]["result"]["tools"]]
    if names != [*ANALYSIS_TOOLS, "search_corpus", "server_stats"]:
        raise AssertionError(f"tools/list: {names}")
    host = build_server(offline=True, device="cpu")
    for i, name in enumerate(ANALYSIS_TOOLS):
        resp = by_id[10 + i]["result"]
        if name == "x_pulse":
            if not (resp["isError"] and "x is not configured" in resp["content"][0]["text"]):
                raise AssertionError(f"x_pulse: {resp}")
            continue
        if resp["isError"]:
            raise AssertionError(f"{name}: {resp['content'][0]['text']}")
        json_close(drop_clock(json.loads(resp["content"][0]["text"])), drop_clock(tool(host, name, args[name])))
    log(
        f"phase20 mcp --offline --index --encoder over stdio (a subprocess on the card): "
        f"initialize, tools/list (the reference's 8 names in its order), each analysis tool "
        f"equal to an offline server's on the CPU, x_pulse 'x is not configured'; {secs:.2f} s "
        f"[{card}]"
    )


def phase_item14(card, state) -> dict:
    """Phase 20: ROADMAP item 14 on phase 18's index and checkpoint and
    phase 19's analyzer head. Returns kernel A's launches in it."""
    docs, syn, ck, prefix = state["docs"], state["syn"], state["ck"], state["prefix"]
    t0 = time.perf_counter()
    item14_doctor(prefix, card)
    item14_cli(ck, card)
    scan = item14_tools(docs, card)
    launches = item14_mixed(prefix, ck, docs, syn, scan, card)
    item14_stdio(prefix, ck, card)
    free_device()
    log(f"phase20 done in {time.perf_counter() - t0:.1f} s [{card}]")
    return {"i8_top2g": {"item14_launches": launches}}


# ---------------------------------------------------------------------------
# Phase 21: sharded serving over a mesh (ROADMAP item 13)
# ---------------------------------------------------------------------------

MESH_SHARDS = 4  # 21.1: four shards of phase 4's corpus on the one card
CHILD_TIMEOUT_S = 240  # 21.4, 21.5: each child process is killed after this
LIVE_ADDS = 2_048  # 21.6: docs added to the sharded live corpus
MERGE_REPS = 20


def card_mesh(data: int, corpus: int):
    """A data x corpus mesh whose cells all sit on the one card: the
    measurement instrument of ``make_mesh(devices=...)`` (the shards run
    one after another on the same SMs)."""
    return make_mesh(data=data, corpus=corpus, devices=[torch.device("cuda", 0)] * (data * corpus))


def strings_for(index, term_ids) -> list:
    """Query strings whose tokens encode to ``term_ids`` over ``index``."""
    names = {i: t for t, i in index.vocab.token_to_id.items()}
    strings = [" ".join(names[t] for t in ids) for ids in term_ids]
    if [encode_query(index, s) for s in strings] != [list(t) for t in term_ids]:
        raise AssertionError("the query strings do not encode to the phase's term ids")
    return strings


def mesh_step_ms(sr, term_ids, q) -> tuple:
    """The sharded hybrid step alone, as a callable over every sub-batch
    (the split plans made and the batch staged on the card beforehand, as
    one card's ``prepare`` does), with the host's global plan and its
    split per query batch in ms."""
    prune, mb = auto_prune_m(N_DOCS, C_ARM), max(256, C_ARM)
    plan_ms = synced_ms(
        lambda: build_query_plan(sr.postings, term_ids, max_postings_per_term=prune, multi_budget=mb), 3
    )
    split = lambda: shard_query_plans(  # noqa: E731
        sr.postings, term_ids, sr.n_shards, shard_size=sr.shard_size,
        max_postings_per_term=prune, multi_budget=mb,
    )
    split_ms = synced_ms(split, 3)
    pdi, pw, meta = split()
    pdi, pw = torch.from_numpy(pdi).cuda(), torch.from_numpy(pw).cuda()
    q_t = torch.from_numpy(q).cuda()
    q8 = T.quantize_int8(q_t)

    def step():
        for lo in range(0, len(term_ids), BATCH):
            sl = slice(lo, lo + BATCH)
            sharded.sharded_hybrid_topk(
                sr.mesh, sr._emb, q_t[sl], pdi[:, sl], pw[:, sl], K,
                candidates_per_arm=C_ARM, kernel=sr.kernel, presorted=meta.presorted,
                max_run=meta.max_terms, queries_i8=q8[sl], n_docs_true=sr.n_docs,
            )

    return step, plan_ms, split_ms


def mesh_main(corpus, strings, card) -> tuple:
    """21.1: ``ShardedHybridRetriever`` over phase 4's corpus, 1 x 4 on the
    card (kernel A per shard): its launches, its plain twin, recall@10,
    the BM25 arm against one card's, a 2 x 4 grid; the step beside one
    card's, kernel A per shard launch and the gather and merge. Returns
    (retriever, single-card retriever, its prepared batch, kernel A's
    record)."""
    index, dense, term_ids, q, _ = corpus
    t0 = time.perf_counter()
    sr = ShardedHybridRetriever(index, dense, mesh=card_mesh(1, MESH_SHARDS), device_batch=BATCH)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    if sr.kernel != "int8" or sr.shard_size != 327_680:
        raise AssertionError(f"mesh retriever: {sr.kernel}, shards of {sr.shard_size}")
    kw = dict(query_embeddings=q, k=K, candidates_per_arm=C_ARM)
    res, counts = counted(lambda: sr.search(strings, **kw))
    expect_launches(counts, i8_top2g=MESH_SHARDS * N_BATCHES)
    check_result(res)
    if not same_result(res, sr.search(strings, plain=True, **kw)):
        raise AssertionError("the sharded int8 path differs from its plain-twin run")
    retr, prep = build_path(corpus, None)
    recall = recall_at_k(
        res.ids, exact_hybrid(retr, prep, retr.dense._rescore_emb, f32_queries(corpus, prep))
    )
    if recall < RECALL_FLOOR:
        raise AssertionError(f"sharded recall@{K} {recall:.4f} < {RECALL_FLOOR}")
    bm, bm_counts = counted(lambda: sr.search(strings, k=K, mode="bm25"))
    expect_launches(bm_counts)
    if not same_result(bm, retr.bm25.search(strings, k=K)):
        raise AssertionError("the sharded BM25 arm differs from one card's")
    grid = ShardedHybridRetriever(index, dense, mesh=card_mesh(2, MESH_SHARDS), device_batch=BATCH)
    res24, counts24 = counted(lambda: grid.search(strings, **kw))
    expect_launches(counts24, i8_top2g=2 * MESH_SHARDS * N_BATCHES)
    if not same_result(res24, res):
        raise AssertionError("the 2 x 4 grid differs from the 1 x 4 grid")
    del grid
    free_device()
    step, plan_ms, split_ms = mesh_step_ms(sr, term_ids, q)
    mesh_ms, one_ms = (
        ms / N_BATCHES
        for ms in paired_medians(step, lambda: retr.run_prepared_device(prep), 5)
    )
    search_ms = synced_ms(lambda: sr.search(strings, **kw), 3)
    # kernel A on one shard at the path's shapes, against its twin
    q8 = prep.queries_i8[0].contiguous()
    emb = sr._emb.parts[(0, 0)]
    group, sub = T.auto_i8_group(sr.shard_size, C_ARM), 8192 // 128
    got = T.i8_top2g_cells(q8, emb, group=group, sub=sub)
    want = T.i8_top2g_cells_plain(q8, emb, group=group, sub=sub)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("kernel A on a shard differs from its twin")
    a_ms = cuda_ms(lambda: T.i8_top2g_cells(q8, emb, group=group, sub=sub), AB_REPS)
    a_plain_ms = cuda_ms(lambda: T.i8_top2g_cells_plain(q8, emb, group=group, sub=sub), 3)
    limit = bound((q8, emb), got, product_ops(q8, emb), "int8")
    # the gather (a copy per cell in one process) and both arms' merges
    dev = torch.device("cuda", 0)
    lists = {
        cell: (
            torch.randn(BATCH, C_ARM, device=dev),
            torch.randint(0, N_DOCS, (BATCH, C_ARM), dtype=torch.int32, device=dev),
        ) * 2
        for cell in sr.mesh.owned
    }

    def gather_merge():
        dv, di, bv, bi = sharded._gather(sr.mesh, lists)
        sharded._merge_gathered(dv[0], di[0], C_ARM)
        sharded._merge_gathered(bv[0], bi[0], C_ARM)

    merge_ms = cuda_ms(gather_merge, MERGE_REPS)
    log(
        f"phase21 mesh 1x{MESH_SHARDS} on one card: {N_DOCS} docs in shards of "
        f"{sr.shard_size} (int8, auto), laid out in {stage_s:.1f} s; {len(strings)} strings: "
        f"kernel A launches {counts['i8_top2g']} ({MESH_SHARDS} per sub-batch of {BATCH}), "
        f"bit-identical to the plain-twin run, recall@{K} vs the exact path {recall:.4f}; "
        f"mode=bm25 bit-identical to one card's BM25 arm; the 2x{MESH_SHARDS} grid "
        f"({counts24['i8_top2g']} launches) bit-identical to 1x{MESH_SHARDS}; step per "
        f"sub-batch {mesh_ms:.3f} ms against one card's {one_ms:.3f} ms (ratio "
        f"{mesh_ms / one_ms:.2f}, medians of 5 in turns, host clock, synced); whole search of "
        f"{len(strings)} {search_ms:.1f} ms; host global plan {plan_ms:.1f} ms and plan + "
        f"split {split_ms:.1f} ms a batch of {len(term_ids)}; kernel A per shard launch "
        f"(B={BATCH}, {sr.shard_size} docs, group {group}) {a_ms:.4f} ms, twin "
        f"{a_plain_ms:.3f} ms, bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}), share "
        f"{limit['bound_ms'] / a_ms:.3f}; gather and merge of {MESH_SHARDS} x 2 lists of "
        f"{BATCH} x {C_ARM} {merge_ms:.4f} ms [{card}]"
    )
    record = {
        "launches": counts["i8_top2g"], "launches_per_sub_batch": MESH_SHARDS,
        "grid_2x4_launches": counts24["i8_top2g"], "recall": recall,
        "shard_ms": a_ms, "shard_plain_ms": a_plain_ms, **{f"shard_{k}": v for k, v in limit.items()},
        "step_ms": mesh_ms, "single_card_step_ms": one_ms, "search_ms": search_ms,
        "plan_ms": plan_ms, "plan_split_ms": split_ms, "gather_merge_ms": merge_ms,
    }
    return sr, retr, prep, record


def mesh_exact(corpus, card) -> dict:
    """21.2: the exact arm per shard, kernel B, at 98,304 x 384 (4 x
    24,576), against one card's kernel B search under the near-tie rule."""
    index, rows, term_ids, q = small_corpus(corpus)
    strings = strings_for(index, term_ids)
    dense = DenseIndex.from_embeddings(rows, dtype=torch.bfloat16)
    sr = ShardedHybridRetriever(index, dense, mesh=card_mesh(1, MESH_SHARDS), device_batch=BATCH)
    if sr.kernel != "pallas" or sr.shard_size != SMALL_DOCS // MESH_SHARDS:
        raise AssertionError(f"mesh retriever: {sr.kernel}, shards of {sr.shard_size}")
    one = HybridRetriever(index, dense, device="cuda", device_batch=BATCH)
    kw = dict(query_embeddings=q, k=K, candidates_per_arm=C_ARM)
    res, counts = counted(lambda: sr.search(strings, **kw))
    expect_launches(counts, fused_topk=MESH_SHARDS * N_BATCHES)
    want = one.search(strings, **kw)
    swaps = near_tie_check(res.scores, res.ids, want.scores, want.ids, atol=TIE)
    emb = sr._emb.parts[(0, 0)]
    qb = torch.from_numpy(q[:BATCH]).cuda().to(emb.dtype)
    b_ms = cuda_ms(lambda: T.dense_topk_pallas(emb, qb, k=C_ARM), AB_REPS)
    vals, ids = T.dense_topk_pallas(emb, qb, k=C_ARM)
    limit = bound((qb, emb), (vals, ids), product_ops(qb, emb), "bf16")
    log(
        f"phase21 exact arm, mesh 1x{MESH_SHARDS}: {SMALL_DOCS} docs x {DIM} bf16 in shards "
        f"of {sr.shard_size} (pallas, auto), kernel B launches {counts['fused_topk']} "
        f"({MESH_SHARDS} per sub-batch); equal to one card's kernel B search ({swaps} "
        f"near-tie swaps); kernel B per shard launch (B={BATCH}, k={C_ARM}) {b_ms:.4f} ms, "
        f"bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}) [{card}]"
    )
    return {
        "launches": counts["fused_topk"], "launches_per_sub_batch": MESH_SHARDS,
        "shard_ms": b_ms, **{f"shard_{k}": v for k, v in limit.items()},
    }


def mesh_filtered(sr, retr, corpus, strings, card) -> dict:
    """21.3: masks of 10 % and 1 % and per-query groups on 21.1's mesh:
    each result bit-identical to its plain-twin run, no masked id, recall@10
    against the exact filtered hybrid; where every pool starves (1 %), the
    result equals one card's filtered search (both are the exact
    fallback's: near-tie rule); the starved rows through
    ``sharded_dense_topk_masked``."""
    _, _, term_ids, q, _ = corpus
    rng = np.random.default_rng(213)
    masks = {"10 %": rng.random(N_DOCS) < 0.1, "1 %": rng.random(N_DOCS) < 0.01}
    include = make_filter_mask(N_DOCS, include_ids=rng.choice(N_DOCS, INCLUDE_DOCS, replace=False))
    rows = retr.dense._rescore_emb
    fallbacks = []
    inner = mesh_retriever.sharded_dense_topk_masked

    def counted_fallback(*a, **kw):
        fallbacks.append(a[2].shape[0])
        return inner(*a, **kw)

    mesh_retriever.sharded_dense_topk_masked = counted_fallback
    kw = dict(query_embeddings=q, k=K, candidates_per_arm=C_ARM)
    out = {}
    try:
        for name, mask in masks.items():
            fallbacks.clear()
            res, counts = counted(lambda: sr.search(strings, filter_mask=mask, **kw))
            expect_launches(counts, i8_top2g=MESH_SHARDS * N_BATCHES)
            no_masked_ids(res, mask)
            if not same_result(res, sr.search(strings, filter_mask=mask, plain=True, **kw)):
                raise AssertionError(f"{name}: the sharded filtered path differs from its plain run")
            prep = retr.prepare(term_ids, q, k=K, candidates_per_arm=C_ARM, filter_mask=mask)
            ev, ei = exact_scores(retr, prep, rows, f32_queries(corpus, prep), torch.from_numpy(mask).cuda())
            recall = recall_at_k(res.ids, ei)
            if recall < RECALL_FLOOR:
                raise AssertionError(f"{name}: sharded filtered recall@{K} {recall:.4f}")
            one = retr.search(strings, filter_mask=mask, **kw)
            agree = int((res.ids == one.ids).all(axis=1).sum())
            starved_rows_n = sum(fallbacks)
            if name == "1 %":
                near_tie_check(res.scores, res.ids, one.scores, one.ids, atol=TIE)
                if starved_rows_n < len(strings):
                    raise AssertionError(f"1 %: only {starved_rows_n} rows took the fallback")
            ms = synced_ms(lambda: sr.search(strings, filter_mask=mask, **kw), 2)
            log(
                f"phase21 filtered {name} ({int(mask.sum())} docs), mesh 1x{MESH_SHARDS}: kernel "
                f"A launches {counts['i8_top2g']}, bit-identical to the plain run, no masked "
                f"id, recall@{K} vs the exact filtered hybrid {recall:.4f}; {agree} of "
                f"{len(strings)} rows equal to one card's filtered search"
                f"{' (all, near-tie rule: both the fallback)' if name == '1 %' else ''}; "
                f"{starved_rows_n} row calls through sharded_dense_topk_masked; search "
                f"{ms:.1f} ms [{card}]"
            )
            out[name] = {"launches": counts["i8_top2g"], "recall": recall, "search_ms": ms,
                         "fallback_rows": starved_rows_n, "rows_equal_single_card": agree}
        stack = np.stack([masks["10 %"], masks["1 %"], np.ones(N_DOCS, bool), include])
        groups = np.arange(len(strings), dtype=np.int32) % stack.shape[0]
        fallbacks.clear()
        res, counts = counted(
            lambda: sr.search(strings, filter_mask=stack, filter_group=groups, **kw)
        )
        expect_launches(counts, i8_top2g=MESH_SHARDS * N_BATCHES)
        for g in range(stack.shape[0]):
            sel = np.flatnonzero(groups == g)
            no_masked_ids(res, stack[g], sel)
            prep = retr.prepare(
                [term_ids[i] for i in sel], q[sel], k=K, candidates_per_arm=C_ARM,
                filter_mask=stack[g],
            )
            q32 = torch.from_numpy(q[sel]).cuda().view(prep.queries.shape[0], -1, DIM)
            ev, ei = exact_scores(retr, prep, rows, q32, torch.from_numpy(stack[g]).cuda())
            if g in (1, 3):  # every pool starves: the exact fallback
                near_tie_check(res.scores[sel], res.ids[sel], ev, ei, atol=TIE)
            elif recall_at_k(res.ids[sel], ei) < RECALL_FLOOR:
                raise AssertionError(f"group {g}: recall below {RECALL_FLOOR}")
        log(
            f"phase21 per-query groups, mesh 1x{MESH_SHARDS}: G=4 rows (10 %, 1 %, all, "
            f"{INCLUDE_DOCS}-doc include-list) round-robin over {len(strings)} queries, kernel A "
            f"launches {counts['i8_top2g']}, no masked id, the starved groups equal to the "
            f"exact filtered hybrid (near-tie rule), the others recall@{K} >= {RECALL_FLOOR}; "
            f"{sum(fallbacks)} row calls through sharded_dense_topk_masked [{card}]"
        )
        out["groups"] = {"launches": counts["i8_top2g"], "fallback_rows": sum(fallbacks)}
    finally:
        mesh_retriever.sharded_dense_topk_masked = inner
    return out


def rank_child(spec_path: str) -> int:
    """One rank of 21.4 (``chip_smoke.py --rank-child SPEC``): join the
    group through ``initialize_distributed``, serve the saved pair over a
    1 x 2 mesh of the one card (the group's ranks, or with one rank two
    cells of it) and write the results; prints one line of JSON with the
    step per sub-batch, the collective's time and the launches."""
    spec = json.loads(open(spec_path).read())
    rank, world = spec["rank"], spec["world"]
    torch.cuda.set_device(0)
    initialize_distributed(
        f"localhost:{spec['port']}", world, rank, backend=spec["backend"],
        timeout_s=CHILD_TIMEOUT_S,
    )
    import torch.distributed as dist

    coll = []
    all_gather = dist.all_gather_into_tensor

    def timed_all_gather(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = all_gather(*a, **kw)
        torch.cuda.synchronize()
        coll.append(time.perf_counter() - t)
        return out

    dist.all_gather_into_tensor = timed_all_gather
    postings = load_postings(f"{spec['prefix']}.postings.npz")
    dense = load_dense(f"{spec['prefix']}.dense.npz")
    strings = json.loads(open(spec["strings"]).read())
    q = np.load(spec["queries"])
    mask = np.load(spec["mask"])
    devices = [torch.device("cuda", 0)] * 2 if world == 1 else None
    sr = ShardedHybridRetriever(
        postings, dense, mesh=make_mesh(data=1, corpus=2, devices=devices), device_batch=BATCH
    )
    kw = dict(query_embeddings=q, k=K, candidates_per_arm=C_ARM)
    res, counts = counted(lambda: sr.search(strings, **kw))
    bm = sr.search(strings, k=K, mode="bm25")
    filt = sr.search(strings, filter_mask=mask, **kw)
    coll.clear()
    search_ms = synced_ms(lambda: sr.search(strings, **kw), 3)
    coll_ms = sum(coll) * 1e3 / 3
    np.savez(
        spec["out"], ids=res.ids, scores=res.scores, bm_ids=bm.ids, bm_scores=bm.scores,
        f_ids=filt.ids, f_scores=filt.scores,
    )
    print(json.dumps({
        "rank": rank, "backend": spec["backend"], "cells": len(sr.mesh.owned),
        "launches": counts["i8_top2g"], "step_ms": search_ms / N_BATCHES,
        "collective_ms": coll_ms / N_BATCHES, "gathers": len(coll) // 3,
    }), flush=True)
    dist.destroy_process_group()
    return 0


def run_children(argvs, tmp) -> list:
    """Start every argv as a process of its own at once and wait for all,
    within CHILD_TIMEOUT_S: a child that fails or outlives it fails the
    phase, and the others are killed then. Returns (code, stdout, stderr,
    seconds) per argv."""
    procs, results = [], {}
    t0 = time.perf_counter()
    for i, argv in enumerate(argvs):
        out, err = open(f"{tmp}/child{i}.out", "w+"), open(f"{tmp}/child{i}.err", "w+")
        procs.append((subprocess.Popen(
            argv, stdout=out, stderr=err, text=True, env=child_env(),
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ), out, err))
    try:
        while len(results) < len(procs):
            for i, (proc, out, err) in enumerate(procs):
                if i in results or proc.poll() is None:
                    continue
                out.seek(0), err.seek(0)
                results[i] = (proc.returncode, out.read(), err.read(), time.perf_counter() - t0)
                if proc.returncode != 0:
                    raise AssertionError(
                        f"child {argvs[i][-3:]} exited {proc.returncode}: {results[i][2][-2000:]}"
                    )
            if time.perf_counter() - t0 > CHILD_TIMEOUT_S:
                raise AssertionError(f"children still running after {CHILD_TIMEOUT_S} s")
            time.sleep(0.1)
    finally:
        for proc, out, err in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close(), err.close()
    return [results[i] for i in range(len(procs))]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_ranks(corpus, strings, tmp, card) -> dict:
    """21.4: two ranks on the one card (gloo, each its own cell of a 1 x 2
    mesh) and a one-rank NCCL world (both cells), each in a process of its
    own over the saved pair: the ranks agree bit for bit, and each equals
    the in-process 1 x 2 mesh."""
    index, dense, _, q, _ = corpus
    prefix = f"{tmp}/big"
    save_index(prefix, index, dense)
    mask = np.random.default_rng(214).random(N_DOCS) < 0.1
    paths = {"strings": f"{tmp}/strings.json", "queries": f"{tmp}/q.npy", "mask": f"{tmp}/mask.npy"}
    open(paths["strings"], "w").write(json.dumps(strings))
    np.save(paths["queries"], q)
    np.save(paths["mask"], mask)
    script = os.path.abspath(__file__)
    specs = []
    gloo_port, nccl_port = free_port(), free_port()
    for rank, world, backend, port in ((0, 2, "gloo", gloo_port), (1, 2, "gloo", gloo_port),
                                       (0, 1, "nccl", nccl_port)):
        spec = {"rank": rank, "world": world, "backend": backend, "port": port,
                "prefix": prefix, "out": f"{tmp}/rank{world}_{rank}.npz", **paths}
        path = f"{tmp}/rank{world}_{rank}.json"
        open(path, "w").write(json.dumps(spec))
        specs.append((spec, path))
    t0 = time.perf_counter()
    results = run_children([[sys.executable, script, "--rank-child", p] for _, p in specs], tmp)
    wall = time.perf_counter() - t0
    stats = [json.loads(r[1].strip().splitlines()[-1]) for r in results]
    outs = [np.load(spec["out"]) for spec, _ in specs]
    here = ShardedHybridRetriever(index, dense, mesh=card_mesh(1, 2), device_batch=BATCH)
    kw = dict(query_embeddings=q, k=K, candidates_per_arm=C_ARM)
    want = {
        "": here.search(strings, **kw), "bm_": here.search(strings, k=K, mode="bm25"),
        "f_": here.search(strings, filter_mask=mask, **kw),
    }
    for out in outs:
        for key, res in want.items():
            if not (np.array_equal(out[f"{key}ids"], res.ids)
                    and np.array_equal(out[f"{key}scores"], res.scores)):
                raise AssertionError(f"a rank's {key or 'hybrid '}results differ from the in-process mesh")
    for st in stats:
        if st["launches"] != N_BATCHES * st["cells"]:
            raise AssertionError(f"rank launches {st}")
    g0, g1, nccl = stats
    log(
        f"phase21 ranks: 2 gloo processes on the one card (a cell each of a 1x2 mesh) and a "
        f"one-rank NCCL world (both cells), over the saved pair: hybrid, bm25 and a 10 % "
        f"filter, every rank bit-identical to the others and to the in-process 1x2 mesh; "
        f"kernel A launches per rank {g0['launches']}/{g1['launches']}/{nccl['launches']}; "
        f"step per sub-batch (whole search / {N_BATCHES}, median of 3, host clock) gloo "
        f"{g0['step_ms']:.2f}/{g1['step_ms']:.2f} ms, of it the all_gather "
        f"{g0['collective_ms']:.2f}/{g1['collective_ms']:.2f} ms (share "
        f"{g0['collective_ms'] / g0['step_ms']:.3f}), NCCL {nccl['step_ms']:.2f} ms, its "
        f"all_gather {nccl['collective_ms']:.3f} ms (share "
        f"{nccl['collective_ms'] / nccl['step_ms']:.3f}); the three processes {wall:.1f} s "
        f"[{card}]"
    )
    del here
    free_device()
    return {"gloo": g0, "gloo_rank1": g1, "nccl": nccl, "prefix": prefix}


def mcp_session(prefix, texts) -> tuple:
    """``mcp --offline --index PREFIX --mesh 1 --updatable`` as a
    subprocess on the card, driven one request at a time over stdio:
    (tool names and the tools' replies, seconds)."""
    import select

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "openintel_tpu_torch.cli.main", "mcp", "--offline", "--index",
         prefix, "--mesh", "1", "--updatable"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=child_env(), cwd=os.path.dirname(os.path.abspath(__file__)),
    )

    def call(rid, method, params=None):
        proc.stdin.write(json.dumps({"jsonrpc": "2.0", "id": rid, "method": method,
                                     "params": params or {}}) + "\n")
        proc.stdin.flush()
        while True:
            left = CHILD_TIMEOUT_S - (time.perf_counter() - t0)
            if left <= 0 or not select.select([proc.stdout], [], [], left)[0]:
                raise AssertionError(f"mcp --mesh: no reply to {method} in time")
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"mcp --mesh exited: {proc.stderr.read()[-2000:]}")
            reply = json.loads(line)
            if reply.get("id") == rid:
                return reply

    def tool_call(rid, name, args):
        result = call(rid, "tools/call", {"name": name, "arguments": args})["result"]
        if result["isError"]:
            raise AssertionError(f"{name}: {result['content'][0]['text']}")
        return json.loads(result["content"][0]["text"])

    try:
        call(1, "initialize")
        names = [t["name"] for t in call(2, "tools/list")["result"]["tools"]]
        first = tool_call(3, "search_corpus", {"queries": texts["queries"], "k": K})
        added = tool_call(4, "index_documents", {"texts": texts["new"]})
        found = tool_call(5, "search_corpus", {"queries": [texts["probe"]], "k": 3})
        tool_call(6, "delete_documents", {"ids": added["ids"]})
        gone = tool_call(7, "search_corpus", {"queries": [texts["probe"]], "k": 3})
        stats = tool_call(8, "server_stats", {})
    finally:
        proc.stdin.close()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return (names, first, added, found, gone, stats), time.perf_counter() - t0


def mesh_entry_points(corpus, strings, prefix, tmp, card) -> dict:
    """21.5: ``search --mesh 1`` through the CLI, equal to the in-process
    1 x 1 mesh; ``--mesh 4`` refused with exit 1 and the reference's text
    (one card); ``mcp --index --mesh 1 --updatable`` over stdio, its live
    tools; ``search --mesh 2 --coordinator`` as 2 processes with
    ``--device cpu``, both equal to the in-process CPU mesh's output."""
    index, dense = corpus[:2]
    sub = strings[:BATCH]
    argv = ["search", *sub, "--index", prefix, "--format", "json", "-k", str(K)]
    t0 = time.perf_counter()
    payload, counts = counted(lambda: cli_json([*argv, "--mesh", "1"]))
    cli_s = time.perf_counter() - t0
    expect_launches(counts, i8_top2g=1)
    one = ShardedHybridRetriever(index, dense, data=1, corpus=1, device="cuda", device_batch=BATCH)
    same_hits(payload, one.search(sub, k=K, candidates_per_arm=2 * K))
    del one
    free_device()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli_main([*argv[:2], "--index", prefix, "--mesh", "4"])
    n_cards = torch.cuda.device_count()
    if n_cards < 4 and (code, out.getvalue().strip()) != (1, f"error: --mesh 4: mesh 1x4 != {n_cards} devices"):
        raise AssertionError(f"--mesh 4 on {n_cards} card(s): {code} {out.getvalue()[:200]}")
    # the CPU pair for the coordinated processes: phase 5's texts
    docs, text_queries = text_corpus()
    path = f"{tmp}/texts.txt"
    with open(path, "w") as f:
        f.write("\n".join(docs) + "\n")
    if cli_main(["index", path, "--out", f"{tmp}/texts"]) != 0:
        raise AssertionError("index of the texts failed")
    text_argv = ["search", *text_queries[:12], "--index", f"{tmp}/texts", "--format", "json",
                 "--mesh", "2", "--device", "cpu"]
    port = free_port()
    child = [sys.executable, "-c", _CHILD]
    rng = np.random.default_rng(215)
    probe = "meshfreshterm " + strings_of(rng, 1)[0]
    texts = {"queries": strings[:8], "new": [probe], "probe": probe}
    with contextlib.ExitStack() as stack:
        from concurrent.futures import ThreadPoolExecutor

        pool = stack.enter_context(ThreadPoolExecutor(2))
        session = pool.submit(mcp_session, prefix, texts)
        t0 = time.perf_counter()
        ranks = run_children(
            [[*child, *text_argv, "--coordinator", f"localhost:{port}", "--num-processes", "2",
              "--process-id", str(r)] for r in (0, 1)],
            tmp,
        )
        coord_s = time.perf_counter() - t0
        (names, first, added, found, gone, stats), mcp_s = session.result()
    here = cli_json(text_argv)
    for _, stdout, _, _ in ranks:
        if json.loads(stdout) != here:
            raise AssertionError("a coordinated rank's output differs from the in-process mesh's")
    if names[-5:] != ["search_corpus", "index_documents", "delete_documents", "compact_corpus", "server_stats"]:
        raise AssertionError(f"mcp --mesh --updatable tools: {names}")
    if any(not r["hits"] for r in first["results"]):
        raise AssertionError("mcp --mesh: a search came back empty")
    new_id = added["ids"][0]
    if new_id != N_DOCS or found["results"][0]["hits"][0]["doc_id"] != new_id:
        raise AssertionError(f"mcp --mesh: the added doc {added['ids']} was not found first")
    if any(h["doc_id"] == new_id for h in gone["results"][0]["hits"]):
        raise AssertionError("mcp --mesh: a deleted doc came back")
    log(
        f"phase21 entry points: cli search --mesh 1 ({len(sub)} strings, one process call, "
        f"{cli_s:.2f} s) json equal to the in-process 1x1 mesh, kernel A launches "
        f"{counts['i8_top2g']}; --mesh 4 on {n_cards} card(s): exit {code}, "
        f"{out.getvalue().strip()!r}; mcp --index --mesh 1 --updatable over stdio (a "
        f"subprocess on the card, {mcp_s:.1f} s): {len(names)} tools, 8 strings answered, a "
        f"doc added (id {new_id}) found first and gone after its delete, stats "
        f"{stats.get('updatable')}; search --mesh 2 --coordinator as 2 processes with "
        f"--device cpu ({coord_s:.1f} s, gloo) both equal to the in-process CPU mesh's json "
        f"[{card}]"
    )
    return {"cli_launches": counts["i8_top2g"], "cli_s": cli_s, "mcp_s": mcp_s,
            "coordinator_s": coord_s}


def exact_live_mesh(upd, strings, c: int) -> np.ndarray:
    """``exact_live`` for the sharded live corpus: the stored rows of its
    shards (their padding cut) and the delta's, the combined index, f32
    queries, the tombstones and RRF. Returns (B, K) ids."""
    st = upd._st
    base = st.base
    main = torch.cat([base._emb.rescore[(0, s)] for s in range(base.n_shards)])[: st.n_main]
    merged = merge_postings(upd.main_postings, st.delta_postings, st.n_total)
    rows = main if st.delta_dense is None else torch.cat([main, st.delta_dense._emb_device])
    alive = torch.from_numpy(st.alive).cuda()
    term_ids = [encode_query(merged, s) for s in strings]
    plan = grouped_query_plan(
        merged, term_ids, st.alive[None, :], np.zeros(len(strings), np.int32),
        max_postings_per_term=auto_prune_m(st.n_total, c), multi_budget=max(256, c),
    )
    b_vals, b_ids = bm25_topk_device(
        torch.from_numpy(plan.doc_ids).cuda(), torch.from_numpy(plan.weights).cuda(),
        st.n_total, c, presorted=plan.presorted, max_run=plan.max_terms,
    )
    q32 = torch.from_numpy(base.embedder(strings)).cuda()
    _, d_ids = dense_topk_xla_masked(rows, q32, alive, c)
    return rrf_fuse_device(b_ids, d_ids, K)[1].cpu().numpy()


def mesh_live(corpus, card) -> dict:
    """21.6: the sharded live corpus on 21.1's mesh shape: 2,048 docs added
    (the fused arms of one sharded step), 1 % of the ids deleted (the
    mask-aware arms), then ``compact_in_place``; each search bit-identical
    to its plain run, no deleted id, recall@10 against the exact combined
    index >= 0.95, as phase 17 holds one card's."""
    index, dense = corpus[:2]
    t0 = time.perf_counter()
    upd = ShardedUpdatableHybridRetriever(
        index, dense, mesh=card_mesh(1, MESH_SHARDS), device_batch=BATCH
    )
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    rng = np.random.default_rng(216)
    texts = [a + " " + b for a, b in zip(strings_of(rng, LIVE_ADDS), strings_of(rng, LIVE_ADDS))]
    strings = strings_of(rng, BATCH)
    kw = {"k": K, "candidates_per_arm": 2 * K}
    steps = {}

    def check(label, launches):
        res, counts = counted(lambda: upd.search(strings, **kw))
        expect_launches(counts, i8_top2g=launches)
        if not same_result(res, upd.search(strings, plain=True, **kw)):
            raise AssertionError(f"live {label}: differs from its plain run")
        if not upd._st.alive[res.ids[res.ids >= 0]].all():
            raise AssertionError(f"live {label}: a deleted id came back")
        recall = recall_at_k(res.ids, exact_live_mesh(upd, strings, 2 * K))
        if recall < RECALL_FLOOR:
            raise AssertionError(f"live {label}: recall@{K} {recall:.4f} < {RECALL_FLOOR}")
        steps[label] = (recall, synced_ms(lambda: upd.search(strings, **kw), 3))

    t0 = time.perf_counter()
    ids = upd.add_documents(texts)
    add_s = time.perf_counter() - t0
    if ids.tolist() != list(range(N_DOCS, N_DOCS + LIVE_ADDS)):
        raise AssertionError("add_documents gave other ids")
    check("added", MESH_SHARDS)  # the fused hook: one sharded step
    victims = rng.choice(N_DOCS + LIVE_ADDS, (N_DOCS + LIVE_ADDS) // 100, replace=False)
    upd.delete_ids(victims)
    check("deleted", MESH_SHARDS)  # the mask-aware dense arm's one step
    mesh = upd.mesh
    t0 = time.perf_counter()
    id_map = upd.compact_in_place()
    compact_s = time.perf_counter() - t0
    if upd.mesh is not mesh or int((id_map >= 0).sum()) != upd.n_docs:
        raise AssertionError("compaction moved the mesh or lost docs")
    check("compacted", MESH_SHARDS)
    log(
        f"phase21 live corpus, mesh 1x{MESH_SHARDS}: laid out in {stage_s:.1f} s; "
        f"{LIVE_ADDS} added in {add_s:.2f} s, {len(victims)} deleted, compacted in place in "
        f"{compact_s:.1f} s to {upd.n_docs} docs on the same mesh; {BATCH} strings each "
        f"time bit-identical to the plain run, no deleted id, recall@{K} vs the exact "
        f"combined index and search ms: "
        + ", ".join(f"{k} {r:.4f} / {ms:.1f} ms" for k, (r, ms) in steps.items())
        + f", kernel A {MESH_SHARDS} launches each [{card}]"
    )
    return {name: {"recall": r, "search_ms": ms} for name, (r, ms) in steps.items()}


def phase_mesh(corpus, card) -> dict:
    """Phase 21: sharded serving (ROADMAP item 13) on phase 4's corpus.
    Returns kernel A's and B's mesh records for the ``kernels`` line."""
    t0 = time.perf_counter()
    index, _, term_ids, _, _ = corpus
    strings = strings_for(index, term_ids)
    sr, retr, _, a_rec = mesh_main(corpus, strings, card)
    filtered = mesh_filtered(sr, retr, corpus, strings, card)
    del sr, retr
    free_device()
    b_rec = mesh_exact(corpus, card)
    free_device()
    with tempfile.TemporaryDirectory(prefix="oi_phase21_") as tmp:
        ranks = mesh_ranks(corpus, strings, tmp, card)
        entry = mesh_entry_points(corpus, strings, ranks.pop("prefix"), tmp, card)
    free_device()
    live = mesh_live(corpus, card)
    free_device()
    log(f"phase21 done in {time.perf_counter() - t0:.1f} s [{card}]")
    a_rec.update(filtered=filtered, ranks=ranks, entry_points=entry, live=live)
    return {"i8_top2g": {"mesh": a_rec}, "fused_topk": {"mesh": b_rec}}


# ---------------------------------------------------------------------------
# Phase 22: the encoder's tensor parallelism (ROADMAP item 13b)
# ---------------------------------------------------------------------------

TP_STEPS = 20  # 22.1: steps of each run, one card and each mesh
TP_MESHES = ((1, 4), (2, 2))  # data x model meshes of the one card
TP_TOL = dict(rtol=2e-3, atol=2e-4)  # losses against one card's: the reference's mesh test
TP_ROUNDS, TP_REPS = 5, 5  # 22.2: rounds in turns x steps timed each
TP_PROFILED = 5  # 22.2: steps under the profiler
TP_CLI_STEPS = 3  # 22.4: steps of train --mesh through the CLI


def tp_train(docs, syn, mesh, ck) -> tuple:
    """``train_encoder`` for TP_STEPS at phase 18's settings, on the card or
    over ``mesh``, checkpointed to ``ck``: (result, median step in ms
    on the host clock, synced by the loss, batch making included)."""
    starts, make_pairs = [], train_mod.make_pairs

    def stamped(*args, **kw):  # a step starts with its batch
        starts.append(time.perf_counter())
        return make_pairs(*args, **kw)

    train_mod.make_pairs = stamped
    try:
        res = train_encoder(
            docs, EncoderConfig(), steps=TP_STEPS, batch_size=ENC_BATCH, lr=ENC_LR, seed=0,
            ckpt_dir=ck, ckpt_every=TP_STEPS, mesh=mesh, synonym_map=syn, flip_p=ENC_FLIP,
            device="cuda",
        )
    finally:
        train_mod.make_pairs = make_pairs
    losses = np.array(res.losses)
    if losses.shape != (TP_STEPS,) or not np.isfinite(losses).all():
        raise AssertionError(f"training gave losses {losses[:4]}...")
    if next(res.params.parameters()).device.type != "cuda":
        raise AssertionError("the trained encoder is not on the card")
    return res, statistics.median(np.diff(starts)[1:]) * 1e3


def tp_mesh_runs(docs, syn, tmp, card) -> dict:
    """22.1: TP_STEPS steps on the card, then over each mesh of TP_MESHES
    from the same seed: every step's loss within TP_TOL of the card's."""
    runs = {"card": tp_train(docs, syn, None, f"{tmp}/tp_card")}
    for data, corpus in TP_MESHES:
        runs[f"{data}x{corpus}"] = tp_train(docs, syn, card_mesh(data, corpus), f"{tmp}/tp_{data}x{corpus}")
    one = runs["card"][0]
    parts = []
    for name, (res, ms) in runs.items():
        if name == "card":
            continue
        drift = np.abs(np.array(res.losses) - one.losses)
        if not np.allclose(res.losses, one.losses, **TP_TOL):
            bad = int(np.argmax(drift > TP_TOL["atol"] + TP_TOL["rtol"] * np.abs(one.losses)))
            raise AssertionError(f"mesh {name}: loss at step {bad} {res.losses[bad]} vs one card {one.losses[bad]}")
        w_err = max(
            float((a - b).detach().abs().max()) for a, b in zip(res.params.parameters(), one.params.parameters())
        )
        parts.append(
            f"{name}: losses within {drift.max():.3g} of one card's (rtol {TP_TOL['rtol']}, atol "
            f"{TP_TOL['atol']}), step 0 {res.losses[0]:.6f}, step {TP_STEPS - 1} {res.losses[-1]:.6f}, "
            f"final weights within {w_err:.3g}, median step {ms:.1f} ms"
        )
    log(
        f"phase22 mesh training: the CLI's default EncoderConfig, {TP_STEPS} steps of batch {ENC_BATCH} "
        f"at lr {ENC_LR} on phase 18's {ENC_DOCS} synonym docs, one seed; one card: loss "
        f"{one.losses[0]:.6f} -> {one.losses[-1]:.6f}, median step {runs['card'][1]:.1f} ms; "
        + "; ".join(parts) + f" (host clock, synced by the loss, batch making included) [{card}]"
    )
    return {name: res for name, (res, _) in runs.items()}


def tp_steppers(model, docs, syn) -> dict:
    """22.2: a training step (zero_grad, loss, backward, AdamW, the loss
    read) for one card and each mesh of TP_MESHES, from the same weights,
    over the same batches staged on the card beforehand."""
    embedder = NeuralEmbedder(model.cfg, model, device="cuda")
    rng = np.random.default_rng(222)
    batches = [
        train_mod.make_pairs(docs, embedder, ENC_BATCH, rng, synonym_map=syn, flip_p=ENC_FLIP, device="cuda")
        for _ in range(4)
    ]
    owners = {"card": (model, info_nce_loss)}
    for data, corpus in TP_MESHES:
        owners[f"{data}x{corpus}"] = (
            tensor_parallel.shard_encoder(model, card_mesh(data, corpus)), tensor_parallel.info_nce_loss
        )

    def stepper(owner, loss_fn):
        opt, turn = train_mod._adamw(owner, ENC_LR), itertools.count()

        def step():
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(owner, *batches[next(turn) % len(batches)])
            loss.backward()
            opt.step()
            return loss.item()

        return step

    return {name: stepper(*pair) for name, pair in owners.items()}


def tp_profile(step) -> dict:
    """``torch.profiler`` over TP_PROFILED steps: device time and launches a
    step, and the share of the device time in the kernels launched under
    ``tp.spread`` and ``tp.sum`` (the cross-cell copies and sums, forward
    and backward)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TP_PROFILED):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    labels = ("tp.spread", "tp.sum")
    dev = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in labels]
    total_us = sum(e.self_device_time_total for e in dev)
    if not total_us:
        raise AssertionError("the profiler saw no device time")
    split_us = sum(
        e.device_time_total for e in events if e.key in labels and e.device_type == DeviceType.CPU
    )
    return {
        "device_ms": total_us / TP_PROFILED / 1e3,
        "launches": sum(e.count for e in dev) / TP_PROFILED,
        "split_share": split_us / total_us,
        "busy_share": total_us / wall_us,
    }


def tp_timing(model, docs, syn, card) -> dict:
    """22.2: each mesh's step against one card's, in turns (TP_ROUNDS
    rounds of TP_REPS steps each, the order rotating), and each one's
    profile."""
    steps = tp_steppers(model, docs, syn)
    names = list(steps)
    for fn in steps.values():
        fn()  # warm
    times = {name: [] for name in names}
    for r in range(TP_ROUNDS):
        for name in names[r % len(names):] + names[: r % len(names)]:
            times[name].append(synced_ms(steps[name], TP_REPS))
    med = {name: statistics.median(t) for name, t in times.items()}
    prof = {name: tp_profile(fn) for name, fn in steps.items()}
    log(
        f"phase22 step time: median of {TP_ROUNDS} rounds in turns of {TP_REPS} steps each (host "
        f"clock, synced by the loss; batches staged on the card): one card {med['card']:.2f} ms, "
        + ", ".join(
            f"{n} {med[n]:.2f} ms ({med[n] / med['card']:.2f} x one card's)" for n in names[1:]
        )
        + "; by the profiler over "
        + f"{TP_PROFILED} steps: "
        + "; ".join(
            f"{n} device {p['device_ms']:.2f} ms a step in {p['launches']:.0f} launches, busy share "
            f"{p['busy_share']:.3f}, the cross-cell copies and sums {p['split_share']:.3f} of the "
            "device time"
            for n, p in prof.items()
        )
        + f" [{card}]"
    )
    del steps
    free_device()
    return {"step_ms": med, "profile": prof}


def tp_checkpoint(docs, syn, tmp, card) -> None:
    """22.3: the 1 x 4 run's gathered checkpoint has a one-card
    checkpoint's keys and shapes, and resumes one step on the card, on the
    CPU (weights within ENC_TOL) and on the 2 x 2 mesh (loss within
    TP_TOL). The CPU run is the named exception to no-CPU-fallback."""
    import shutil

    with np.load(f"{tmp}/tp_1x4/encoder.npz") as a, np.load(f"{tmp}/tp_card/encoder.npz") as b:
        if {k: a[k].shape for k in a.files} != {k: b[k].shape for k in b.files}:
            raise AssertionError("the mesh checkpoint's keys or shapes differ from one card's")
        n_keys = len(a.files)
    resumed = {}
    for name, mesh, dev in (("card", None, "cuda"), ("cpu", None, "cpu"), ("2x2", card_mesh(2, 2), "cuda")):
        shutil.copytree(f"{tmp}/tp_1x4", f"{tmp}/tp_resume_{name}")
        logs = []
        resumed[name] = train_encoder(
            docs, EncoderConfig(), steps=TP_STEPS + 1, batch_size=ENC_BATCH, lr=ENC_LR, seed=0,
            ckpt_dir=f"{tmp}/tp_resume_{name}", mesh=mesh, synonym_map=syn, flip_p=ENC_FLIP,
            device=dev, log=logs.append,
        )
        if f"resumed from step {TP_STEPS}" not in logs or len(resumed[name].losses) != 1:
            raise AssertionError(f"resume on {name}: {logs}")
    w_err = max(
        float((a.detach().cpu() - b.detach()).abs().max())
        for a, b in zip(resumed["card"].params.parameters(), resumed["cpu"].params.parameters())
    )
    l_card, l_cpu, l_mesh = (resumed[n].losses[0] for n in ("card", "cpu", "2x2"))
    if w_err > ENC_TOL or abs(l_card - l_cpu) > ENC_TOL * abs(l_cpu):
        raise AssertionError(f"one resumed step: weights differ by {w_err:.3g}, loss {l_card} vs {l_cpu}")
    if not np.isclose(l_mesh, l_card, **TP_TOL):
        raise AssertionError(f"the 2x2 mesh's resumed loss {l_mesh} vs the card's {l_card}")
    log(
        f"phase22 checkpoint: the 1x4 run's gathered checkpoint ({n_keys} arrays) has one card's keys "
        f"and shapes; one more step resumed on the card and on the CPU (the named CPU half): weights "
        f"within {w_err:.3g} (<= {ENC_TOL}), loss {l_card:.6f} vs {l_cpu:.6f}; on the 2x2 mesh loss "
        f"{l_mesh:.6f} (rtol {TP_TOL['rtol']}, atol {TP_TOL['atol']}) [{card}]"
    )
    del resumed
    free_device()


def tp_cli(path, tmp, card) -> None:
    """22.4: ``train --mesh 1xN`` through the CLI on the N cards there are
    (the default EncoderConfig, TP_CLI_STEPS steps): exit 0, the mesh line,
    a loadable checkpoint; ``--mesh 2x4`` on fewer than 8 cards refused
    with the reference's text."""
    n_cards = torch.cuda.device_count()
    spec = f"1x{n_cards}"
    argv = ["train", path, "--out", f"{tmp}/tp_cli", "--mesh", spec, "--steps", str(TP_CLI_STEPS),
            "--batch-size", str(ENC_BATCH), "--lr", str(ENC_LR)]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = cli_main(argv)
    secs = time.perf_counter() - t0
    text = out.getvalue()
    if code != 0 or f"mesh: data=1 x model={n_cards}" not in text or f"trained to step {TP_CLI_STEPS}" not in text:
        raise AssertionError(f"train --mesh {spec}: exit {code}, {text[-400:]!r}")
    emb = load_embedder(f"{tmp}/tp_cli")
    rows = emb(["wa1 wa2 wa3", "wb7"])
    if rows.shape != (2, 256) or not np.isfinite(rows).all():
        raise AssertionError(f"the CLI's mesh checkpoint encodes to {rows.shape}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli_main(argv[:4] + ["--mesh", "2x4"])
    want = f"error: --mesh 2x4: mesh 2x4 != {n_cards} devices"
    if n_cards < 8 and (code, out.getvalue().strip()) != (1, want):
        raise AssertionError(f"train --mesh 2x4: exit {code}, {out.getvalue()!r}")
    log(
        f"phase22 cli train --mesh {spec}: exit 0 in {secs:.2f} s ({TP_CLI_STEPS} steps, the load of "
        f"{ENC_DOCS} docs included), the mesh line, a checkpoint that loads and encodes; --mesh 2x4 on "
        f"{n_cards} card(s) exits 1 with the reference's text [{card}]"
    )
    del emb
    free_device()


def tp_recall(path, ck, prefix, docs, syn) -> float:
    """recall@10 of the served int8 path against the exact path over the
    index ``index --encoder ck`` builds, on 18.4's strings (the library
    path of 18.4, not timed)."""
    with contextlib.redirect_stdout(io.StringIO()):
        if cli_main(["index", path, "--out", prefix, "--encoder", ck]) != 0:
            raise AssertionError(f"cli index --encoder {ck} failed")
    rng = np.random.default_rng(184)
    strings = encoder_queries(docs, syn, rng, BATCH // 2, 1.0)[0] + encoder_queries(docs, syn, rng, BATCH // 2, 0.0)[0]
    emb = load_embedder(ck)
    retr = HybridRetriever(
        load_postings(f"{prefix}.postings.npz"), load_dense(f"{prefix}.dense.npz"), emb, device="cuda",
        device_batch=BATCH,
    )
    term_ids, q_emb = [encode_query(retr.bm25.index, s) for s in strings], emb(strings)
    prep = retr.prepare(term_ids, q_emb, k=K, candidates_per_arm=2 * K)
    served = retr.finalize_prepared(prep, retr.run_prepared_device(prep))
    recall = recall_at_k(served.ids, exact_hybrid(retr, prep, retr.dense._rescore_emb, prep.queries))
    del retr, emb
    free_device()
    return recall


def tp_continue(docs, syn, ck, card) -> None:
    """22.5's encoder: the 1 x 4 run resumed on its mesh to ENC_STEPS,
    phase 18's length of training, its loss falling."""
    logs = []
    t0 = time.perf_counter()
    res = train_encoder(
        docs, EncoderConfig(), steps=ENC_STEPS, batch_size=ENC_BATCH, lr=ENC_LR, seed=0, ckpt_dir=ck,
        ckpt_every=ENC_STEPS, mesh=card_mesh(1, 4), synonym_map=syn, flip_p=ENC_FLIP, device="cuda",
        log=logs.append,
    )
    secs = time.perf_counter() - t0
    losses = np.array(res.losses)
    if f"resumed from step {TP_STEPS}" not in logs or losses.shape != (ENC_STEPS - TP_STEPS,):
        raise AssertionError(f"the 1x4 run did not resume: {logs[:2]}, {losses.shape}")
    head, tail = losses[:10].mean(), losses[-10:].mean()
    if not np.isfinite(losses).all() or not tail < head:
        raise AssertionError(f"the loss did not fall: first 10 {head:.4f}, last 10 {tail:.4f}")
    log(
        f"phase22 1x4 run resumed on its mesh to step {ENC_STEPS} (phase 18's length) in {secs:.2f} s: "
        f"loss {losses[0]:.4f} at step {TP_STEPS} -> {losses[-1]:.4f} (mean of the first 10 "
        f"{head:.4f}, of the last 10 {tail:.4f}) [{card}]"
    )
    del res
    free_device()


def phase_tensor_parallel(card, state, tmp) -> dict:
    """Phase 22: the encoder's tensor parallelism (ROADMAP item 13b) on
    phase 18's corpus, in its directory ``tmp``. Returns kernel A's and B's
    records for the ``kernels`` line (``tensor_parallel``)."""
    t0 = time.perf_counter()
    docs, syn = state["docs"], state["syn"]
    runs = tp_mesh_runs(docs, syn, tmp, card)
    timing = tp_timing(runs["card"].params, docs, syn, card)
    del runs
    free_device()
    tp_checkpoint(docs, syn, tmp, card)
    tp_cli(state["path"], tmp, card)
    early = {name: tp_recall(state["path"], f"{tmp}/tp_{name}", f"{tmp}/tp_idx_{name}", docs, syn)
             for name in ("card", "1x4")}
    log(
        f"phase22 served recall@{K} against the exact path over the {TP_STEPS}-step checkpoints' "
        f"indexes (no limit: {TP_STEPS} steps, not phase 18's {ENC_STEPS}): one card "
        f"{early['card']:.4f}, 1x4 mesh {early['1x4']:.4f} [{card}]"
    )
    ck, prefix = f"{tmp}/tp_1x4", f"{tmp}/tp_enc"
    tp_continue(docs, syn, ck, card)
    encoder_index(state["path"], ck, prefix, card, phase="phase22", reps=1)
    records = encoder_search(prefix, ck, docs, syn, card, phase="phase22")
    free_device()
    log(f"phase22 done in {time.perf_counter() - t0:.1f} s [{card}]")
    records["i8_top2g"].update(step=timing, recall_at_20_steps=early)
    return {name: {"tensor_parallel": rec} for name, rec in records.items()}



# ---------------------------------------------------------------------------
# Phase 23: the measurement tools of the reference's scripts on the card
# ---------------------------------------------------------------------------

TOOL_DOCS = 32_768  # 23.1-23.3: two supers
TOOL_SERVE_DOCS = 131_072  # 23.3: coalescer's and arrival's corpus (pruned plans, int8 auto)
C2_WIDE = (512, 1024)  # 23.1: C2's sub-batches above phase 10's
E2_SCALES = (32.0, 40.0)  # 23.2: the served quantiser scale and int4_ab's second
TOOL_REPS = 2  # 23.3: the timed tools' reps


@contextlib.contextmanager
def tool_env(**env):
    """The tools' environment variables set for the block, then restored."""
    old = {name: os.environ.get(name) for name in env}
    os.environ.update({name: str(val) for name, val in env.items()})
    try:
        yield
    finally:
        for name, val in old.items():
            if val is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = val


def tools_c2_wide(card) -> dict:
    """23.1: kernel C2 at B = 512 and 1,024 (phase 10 held it at 45 and 256)
    over two supers: cells bit-identical to the twin, ``dense_topk_fast_i8``
    to its plain run; its time at each width beside B = 256's, the twin's and
    the bound."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    i8 = convert.int8_corpus(torch.from_numpy(unit_rows(rng, TOOL_DOCS, DIM)).to(dev))
    rec = {}
    for b in (256, *C2_WIDE):
        q8 = T.quantize_int8(torch.from_numpy(unit_rows(rng, b, DIM))).to(dev)
        got = T.i8_turbo_cells(q8, i8, slots=2)
        want = T.i8_turbo_cells_plain(q8, i8, slots=2)
        if not torch.equal(got, want):
            raise AssertionError(f"kernel C2 cells differ at B={b}: {int((got != want).sum())} cells")
        kv, ki = T.dense_topk_fast_i8(i8, q8, k=C_ARM, n_docs=TOOL_DOCS)
        pv, pi = T.dense_topk_fast_i8(i8, q8, k=C_ARM, n_docs=TOOL_DOCS, plain=True)
        if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
            raise AssertionError(f"dense_topk_fast_i8 differs from its plain run at B={b}")
        ms = cuda_ms(lambda: T.i8_turbo_cells(q8, i8, slots=2), 10)
        plain_ms = cuda_ms(lambda: T.i8_turbo_cells_plain(q8, i8, slots=2), 2)
        limit = bound((q8, i8), (got,), product_ops(q8, i8), "int8")
        rec[b] = {"ms": ms, "plain_ms": plain_ms, **limit, "max_abs_err": 0}
    torch.cuda.synchronize()
    log(
        f"phase23.1 kernel C2 at B={'/'.join(map(str, C2_WIDE))} over {TOOL_DOCS} docs x {DIM}: "
        "cells and dense_topk_fast_i8 (k 32) bit-identical to the twin; "
        + "; ".join(
            f"B={b} {r['ms']:.4f} ms ({r['ms'] * 1e3 / b:.3f} us/q), twin {r['plain_ms']:.2f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            for b, r in rec.items()
        )
        + f" [{card}]"
    )
    return rec


def tools_e2_scales(card) -> dict:
    """23.2: ``dense_topk_fast_i4`` (kernel E2) at k = 128 and 256 on the
    int4 corpus of scales 32 and 40 at B = 256 and 1,024, cells and decode
    bit-identical to the plain run; E2 timed on the scale-40 corpus at
    B = 1,024."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(24)
    rows = torch.from_numpy(unit_rows(rng, TOOL_DOCS, DIM)).to(dev)
    cases = 0
    for scale in E2_SCALES:
        packed = convert.int4_corpus(rows, scale=scale)
        for b in (256, 1024):
            q8 = T.quantize_int8(torch.from_numpy(unit_rows(rng, b, DIM))).to(dev)
            got = T.i4_cells(q8, packed, slots=2)
            want = T.i4_cells_plain(q8, packed, slots=2)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"kernel E2 cells differ at scale {scale}, B={b}: {int((got != want).sum())} cells"
                )
            for k in (128, 256):
                kv, ki = T.dense_topk_fast_i4(packed, q8, k=k, n_docs=TOOL_DOCS, scale=scale)
                pv, pi = T.dense_topk_fast_i4(packed, q8, k=k, n_docs=TOOL_DOCS, scale=scale, plain=True)
                if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
                    raise AssertionError(f"dense_topk_fast_i4 differs at scale {scale}, B={b}, k={k}")
                cases += 1
    ms = cuda_ms(lambda: T.i4_cells(q8, packed, slots=2), 10)
    plain_ms = cuda_ms(lambda: T.i4_cells_plain(q8, packed, slots=2), 2)
    limit = bound((q8, packed), (got,), product_ops(q8, rows), "int8")
    torch.cuda.synchronize()
    log(
        f"phase23.2 kernel E2 on the int4 corpus at scales {'/'.join(f'{s:g}' for s in E2_SCALES)}, "
        f"B 256/1024, k 128/256 over {TOOL_DOCS} docs x {DIM}: {cases} cases, cells and "
        f"decode bit-identical to the plain run; at scale 40, B=1024: {ms:.4f} ms, twin "
        f"{plain_ms:.2f} ms, bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}) [{card}]"
    )
    return {"scale40_b1024": {"ms": ms, "plain_ms": plain_ms, **limit, "max_abs_err": 0}}


def tools_run(tmp) -> dict:
    """23.3: each tool's command once at a small size, on the card, its
    output kept apart from this script's (its JSON read back). Returns per
    tool (seconds, JSON, the kernel launches of its window)."""
    cuda = ["--device", "cuda"]
    eq = [
        "--n-docs", "5000", "--n-concepts", "500", "--steps", "10", "--rerank-steps", "10",
        "--queries", "100", "--ckpt-dir", f"{tmp}/eq_ck",
    ]
    runs = {
        "profile_planner": ({"PROF_DOCS": 65_536}, profile_planner, []),
        "coalescer": ({"BENCH_DOCS": TOOL_SERVE_DOCS, "BENCH_CALLERS": 4, "BENCH_SECONDS": 1},
                      coalescer, []),
        "arrival": ({"BENCH_DOCS": TOOL_SERVE_DOCS}, arrival,
                    ["--duration", "0.5", "--fractions", "0.5,2.0"]),
        "encoder_quality": ({}, encoder_quality, eq),
        "fusion_ab": ({}, fusion_ab, ["--n-docs", "2000"]),
        "batch_ab": ({"AB_REPS": TOOL_REPS}, batch_ab, [str(TOOL_DOCS), "1024"]),
        "int4_ab": ({"AB_REPS": TOOL_REPS}, int4_ab, [str(TOOL_DOCS), "1024", "1"]),
    }
    out = {}
    for name, (env, tool, argv) in runs.items():
        path = f"{tmp}/{name}.json"
        text = io.StringIO()
        t0 = time.perf_counter()
        with tool_env(**env), contextlib.redirect_stdout(text), contextlib.redirect_stderr(text):
            rc, counts = counted(lambda: tool.main([*argv, *cuda, "--out", path]))
        if rc != 0:
            raise AssertionError(f"tools.{name} exited {rc}: {text.getvalue()[-2000:]}")
        with open(path) as f:
            out[name] = (time.perf_counter() - t0, json.load(f), counts)
        free_device()
    # the mesh tool's command takes six reps; its core takes fewer here
    t0 = time.perf_counter()
    doc, counts = counted(lambda: {
        **sharded_overhead.sharded_overhead(
            *sharded_overhead.overhead_inputs(sharded_overhead.N_SHARDS * 32_768),
            torch.device("cuda"), reps=TOOL_REPS,
        ),
        **common.stamp(torch.device("cuda")),
    })
    out["sharded_overhead"] = (time.perf_counter() - t0, doc, counts)
    free_device()
    return out


def tools_summary(name: str, doc: dict) -> str:
    """One line of what a tool's JSON says."""
    if name == "profile_planner":
        lead = max(doc["phases"], key=lambda p: doc["phases"][p]["share"])
        return f"{doc['ms_per_query']:.4f} ms/query/core, lead phase {lead}"
    if name == "coalescer":
        return (
            f"{doc['served_b64_concurrent_qps']:.0f} q/s served ({doc['queries_per_wave']:.0f} "
            f"q/wave), raw b=64 {doc['raw_b64_qps']:.0f} q/s"
        )
    if name == "arrival":
        return (
            f"direct cap {doc['direct_capacity_qps']:.0f} q/s, full wave "
            f"{doc['coalesced_capacity_qps']:.0f} q/s"
        )
    if name == "encoder_quality":
        t = doc["tables"]["mismatch"]
        return (
            f"mismatch recall@10 neural-dense {t['neural-dense']['recall@10']:.3f}, "
            f"hashing-dense {t['hashing-dense']['recall@10']:.3f}"
        )
    if name == "fusion_ab":
        t = doc["tables"]["hashing"]
        return ", ".join(f"{label} {row['exact']['recall@10']:.3f}" for label, row in t.items())
    if name == "sharded_overhead":
        return f"overhead ratio {doc['overhead_ratio']:.3f}, matmul probe {doc['matmul_probe_ratio']:.3f}"
    return ", ".join(
        f"{r['label']} {r['ms_median']:.4f} ms" for r in doc["rows"] if "ms_median" in r
    )


def phase_tools(card) -> dict:
    """Phase 23: kernels C2 and E2 at the tools' new shapes against their
    twins, then each tool's command at a small size on the card. Returns the
    ``tools`` records of kernels A, C2 and E2 for the ``kernels`` line."""
    t0 = time.perf_counter()
    # the planner's profile build (g++, host only) beside the card's checks
    build = threading.Thread(target=profile_planner.build_profile_lib)
    build.start()
    c2 = tools_c2_wide(card)
    e2 = tools_e2_scales(card)
    free_device()
    build.join()
    with tempfile.TemporaryDirectory(prefix="oi_phase23_") as tmp:
        runs = tools_run(tmp)
    launches = {}
    for name, (seconds, doc, counts) in runs.items():
        if doc["backend"] != "cuda" or doc["card"] != card:
            raise AssertionError(f"tools.{name} stamped {doc['backend']!r}, {doc['card']!r}")
        launched = {k: n for k, n in counts.items() if n}
        for kernel, n in launched.items():
            launches.setdefault(kernel, {})[name] = n
        log(f"phase23.3 tools.{name} ({seconds:.1f} s): {tools_summary(name, doc)}; launches {launched}")
    ab = (TOOL_REPS + 1) * 2  # the two stages of a timed program: a warm-up rep and the reps
    widths = sum(1024 // b for b in batch_ab.BATCHES)  # batch_ab's sub-batches of its 1,024 queries
    want = {
        "i8_top2g": {"coalescer", "arrival"},
        "turbo_i8_top2": {"batch_ab", "int4_ab"},
        "turbo_i4_top2": {"int4_ab"},
    }
    if {k: set(v) for k, v in launches.items()} != want:
        raise AssertionError(f"phase 23's launches {launches}, expected kernels {want}")
    if (launches["turbo_i8_top2"] != {"batch_ab": ab * widths, "int4_ab": ab}
            or launches["turbo_i4_top2"] != {"int4_ab": 3 * ab}):
        raise AssertionError(f"kernels C2/E2 launched {launches}, expected {ab} a timed sub-batch")
    bad = [r for r in runs["int4_ab"][1]["rows"] if "recall" in r and r["recall"] < RECALL_FLOOR]
    if bad:
        raise AssertionError(f"int4_ab recall@10 under {RECALL_FLOOR}: {bad}")
    log(f"phase23 done in {time.perf_counter() - t0:.1f} s [{card}]")

    def record(kernel, shapes, timed=None):
        return {"tools": {"launches": launches[kernel], "shapes": shapes, **({"timed": timed} if timed else {})}}

    return {
        "i8_top2g": record("i8_top2g", f"coalescer and arrival: the int8 arm over {TOOL_SERVE_DOCS} docs"),
        "turbo_i8_top2": record(
            "turbo_i8_top2", f"B=256, 512, 1024 over {TOOL_DOCS} docs (batch_ab), 1024 (int4_ab's int8 arm); "
            "held to the twin at B=512, 1024", c2,
        ),
        "turbo_i4_top2": record(
            "turbo_i4_top2", f"B=1024 at c=128, 256 and scale 40 over {TOOL_DOCS} docs (int4_ab); "
            "held to the twin at scales 32, 40, B=256, 1024", e2,
        ),
    }



def run(quick: bool, profile: bool) -> None:
    env = phase_environment()
    card = env["card"]
    phase_kernel_a()
    phase_kernel_b()
    phase_kernel_d()
    phase_kernel_e()
    phase_kernel_c_s()
    if quick:
        log("quick run: the paths (phases 4, 5, 12, 13, 8, 9, 11, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23) skipped")
        return

    corpus = build_corpus()
    kernels = [phase_int8_path(corpus, card, profile)]
    free_device()
    shapes = {"a": phase_text(card)}
    free_device()
    small_shapes, windows = phase_small_path(corpus, card, profile)
    shapes.update(small_shapes)
    kernels += b_entries(shapes, windows)
    phase_misfit_width(card)
    free_device()
    kernels.append(phase_fast_path(corpus, card, profile))
    free_device()
    kernels += phase_int4_path(corpus, card, profile)
    free_device()
    kernels += phase_measurement(corpus, card)
    free_device()
    retr = phase_pipelined(corpus, card)
    phase_coalesced(retr, card)
    filtered = phase_filtered(corpus, retr, card, profile)
    entry_points = phase_entry_points(corpus, retr, card)
    del retr
    free_device()
    with tempfile.TemporaryDirectory(prefix="oi_phase18_") as tmp:
        encoder, state = phase_encoder(card, profile, tmp)
        item12 = phase_item12(card, state, tmp)
        item14 = phase_item14(card, state)
        free_device()
        mesh = phase_mesh(corpus, card)
        del corpus
        free_device()
        tensor = phase_tensor_parallel(card, state, tmp)
    del state
    free_device()
    tools = phase_tools(card)
    free_device()
    for entry in kernels:
        entry.update(filtered.get(entry["name"], {}))
        entry.update(entry_points.get(entry["name"], {}))
        entry.update(encoder.get(entry["name"], {}))
        entry.update(item12.get(entry["name"], {}))
        entry.update(item14.get(entry["name"], {}))
        entry.update(mesh.get(entry["name"], {}))
        entry.update(tensor.get(entry["name"], {}))
        entry.update(tools.get(entry["name"], {}))

    leaked = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "openintel_tpu")
    )
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")
    order = [
        "i8_top2g", "fused_topk", "fused_topk_v1", "turbo_f32", "turbo_i4", "turbo_i4_top2",
        "turbo_i8", "turbo_i8_top2", "turbo_i8_v1", "turbo_i8_top2_v1", "dot_only",
        "dot_only_v1",
    ]
    kernels.sort(key=lambda e: order.index(e["name"]))
    log(json.dumps({"kernels": kernels}))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-child":  # 21.4's ranks
        return rank_child(sys.argv[2])
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--quick", action="store_true",
        help="stop after the kernel build and the kernel-vs-twin checks",
    )
    parser.add_argument(
        "--profile", action="store_true",
        help="also profile each full-width path's step (torch.profiler)",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    run(args.quick, args.profile)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
