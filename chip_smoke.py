#!/usr/bin/env python3
"""Drive the PyTorch port's hybrid search on one NVIDIA card and check it.

    python3 chip_smoke.py            # all phases (one card, ~5 min)
    python3 chip_smoke.py --quick    # build + kernel-vs-twin checks only
    python3 chip_smoke.py --profile  # all phases, and a profile of each path

Phases, one line of output each (any failed check raises, exit code != 0),
run in the order 1, 2, 3, 6, 7, 10 (the kernel checks; ``--quick`` stops
there), then 4, 5, 12, 13, 8, 9, 11, 14, 15, 16 (the paths):

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
   each equal to a direct search at its wave's width and masks.

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
path's numbers.

With ``--profile``, phases 4, 8, 9, 12 (each store) and 16 (each int8
mask) add a ``profile`` line:
``torch.profiler`` over 3 runs of the path's sub-batches gives the device
time per sub-batch, the largest kernels, the launches per sub-batch and the
device's busy share of the profiled wall time (a floor: the profiler slows
the host).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from openintel_tpu_torch import convert, native
from openintel_tpu_torch.index.schema import DenseIndex
from openintel_tpu_torch.index.synthetic import (
    synthetic_postings_index,
    synthetic_queries_from_docs,
    synthetic_token_corpus,
)
from openintel_tpu_torch.models.retrievers import (
    HybridRetriever,
    dense_arm_topk,
    filtered_fetch_width,
    make_filter_mask,
    starved_rows,
)
from openintel_tpu_torch.ops import _kernels
from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.ops.bm25 import bm25_topk_device, encode_query
from openintel_tpu_torch.ops.dense import (
    dense_topk_xla,
    dense_topk_xla_masked,
    require_true_f32,
)
from openintel_tpu_torch.serving import BatchCoalescer, PipelinedSearcher
from openintel_tpu_torch.tools import common, grouped_ab, kernel_decomp, topk_reduce_ab

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
    from torch.profiler import ProfilerActivity, profile

    retr.run_prepared_device(prep)  # warm
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            retr.run_prepared_device(prep)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in dev)
    if not total_us:
        raise AssertionError("the profiler saw no device time")
    per = steps * prep.queries.shape[0]
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:3]
    tops = "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / per / 1e3:.3f} ms "
        f"({100 * e.self_device_time_total / total_us:.1f} %)"
        for e in top
    )
    return (
        f"device {total_us / per / 1e3:.3f} ms per sub-batch in "
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


def run(quick: bool, profile: bool) -> None:
    env = phase_environment()
    card = env["card"]
    phase_kernel_a()
    phase_kernel_b()
    phase_kernel_d()
    phase_kernel_e()
    phase_kernel_c_s()
    if quick:
        log("quick run: the paths (phases 4, 5, 12, 13, 8, 9, 11, 14, 15, 16) skipped")
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
    del retr
    free_device()
    for entry in kernels:
        entry.update(filtered.get(entry["name"], {}))

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
