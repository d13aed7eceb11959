#!/usr/bin/env python3
"""Drive the PyTorch port's hybrid search on one NVIDIA card and check it.

    python3 chip_smoke.py            # all phases (one card, ~2 minutes)
    python3 chip_smoke.py --quick    # build + kernel-vs-twin checks only

Phases, one line of output each (any failed check raises, exit code != 0):

1. environment: the card, torch and CUDA versions, the kernel build (nvcc,
   ``openintel_tpu_torch/csrc``) and the C++ query planner;
2. kernel A (``csrc/i8_top2g.cu``) against its plain twin: candidate cells
   bit-identical over groups {1, 2, auto}, both step widths, padding;
3. kernel B (``csrc/fused_topk.cu``) against its plain twin: f32 and bf16,
   k in {10, 32}, k > n_docs, exactly duplicated scores;
4. the main path at full width: 1.25M docs x 384 (bf16 store), the hybrid
   retriever auto-selected to int8, 4 sub-batches of 256 queries through
   prepare -> run_prepared_device -> finalize_prepared; results against the
   plain-twin path, recall@10 against the exact path, per-batch time;
5. text requests: ``HybridRetriever.build`` on ~20k generated docs (kernel B)
   and ``search`` on query strings, against the plain path.

Kernel launch counts are zeroed just before phase 4 and read just after
phase 5: each kernel of the path must have launched. The line before the
last is a JSON object with each kernel's launches, error and time beside
its twin's; the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from openintel_tpu import native
from openintel_tpu.index.synthetic import (
    synthetic_postings_index,
    synthetic_queries_from_docs,
    synthetic_token_corpus,
)
from openintel_tpu_torch import convert
from openintel_tpu_torch.models.retrievers import HybridRetriever
from openintel_tpu_torch.ops import _kernels
from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.ops.bm25 import bm25_topk_device, encode_query
from openintel_tpu_torch.ops.dense import dense_topk_xla, require_true_f32

N_DOCS = 1_250_000  # bench.py's per-chip shard of the 10M-doc corpus
DIM = 384
VOCAB = 30_000
BATCH = 256  # queries per sub-batch
N_BATCHES = 4
K = 10
C_ARM = 32  # candidates per arm
TIE = 1e-5  # near-tie rule: ids may differ only where scores differ by less
ATOL = 2e-6  # kernel B scores against its twin


def log(msg: str) -> None:
    print(msg, flush=True)


def near_tie_check(vals, ids, ref_vals, ref_ids, *, tie=TIE, atol=None) -> int:
    """Ids must equal the reference's except at ranks where the two docs'
    scores differ by less than ``tie``; each row's ids are distinct. With
    ``atol``, scores at equal ids must also agree to it. Returns the number
    of ranks whose ids differ (all within the rule)."""
    vals, ids = np.asarray(vals, np.float64), np.asarray(ids)
    ref_vals, ref_ids = np.asarray(ref_vals, np.float64), np.asarray(ref_ids)
    assert ids.shape == ref_ids.shape, (ids.shape, ref_ids.shape)
    diff = ids != ref_ids
    gap = np.abs(vals - ref_vals)
    if diff.any():
        worst = gap[diff].max()
        assert worst < tie, f"ids differ at a score gap of {worst:.3g}"
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
    n_super = 17  # groups 1, 2 and auto (3): the last group short
    n = (n_super - 1) * T._TURBO_UNIT + 5_000  # the last super short too
    b = 45  # pads to 64 queries
    emb = torch.from_numpy(unit_rows(rng, n, DIM)).to(dev)
    corpus = convert.int8_corpus(emb)
    q8 = T.quantize_int8(torch.from_numpy(unit_rows(rng, b, DIM))).to(dev)
    # tie-heavy operands: entries in {-1, 0, 1}, so equal keys are common
    tie_corpus = T.pad_corpus_i8(
        torch.from_numpy(rng.integers(-1, 2, (n, DIM)).astype(np.int8)).to(dev)
    )
    tie_q = torch.from_numpy(rng.integers(-1, 2, (b, DIM)).astype(np.int8)).to(dev)
    cases = 0
    for crp, q in ((corpus, q8), (tie_corpus, tie_q)):
        q_pad = torch.cat([q, q.new_zeros((64 - b, DIM))])
        for group in (1, 2, T.auto_i8_group(n, C_ARM)):
            for block_c in (4096, 8192):
                sub = block_c // 128
                got = T.i8_top2g_cells(q_pad, crp, group=group, sub=sub)
                want = T.i8_top2g_cells_plain(q_pad, crp, group=group, sub=sub)
                for g, w, name in zip(got, want, ("k1", "k2", "s1", "s2")):
                    if not torch.equal(g, w):
                        bad = int((g != w).sum())
                        raise AssertionError(
                            f"kernel A {name} differs in {bad} cells "
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
        f"phase2 kernel A: {cases} cases (groups 1/2/auto, block_c 4096/8192, "
        f"N={n}, B={b}, D={DIM}, random and tie-heavy) cells and decode "
        "bit-identical to the twin"
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
    checks, swaps = 0, 0
    for dtype in (torch.float32, torch.bfloat16):
        cases = [
            (base, queries, 10), (base, queries, 32),
            (base[:20], queries, 32),  # k > n_docs: (0.0, -1) slots
            (dup, base[:8], 10),  # exactly equal scores, lower id first
        ]
        for docs, q, k in cases:
            d = torch.from_numpy(docs).to(dev, dtype)
            qq = torch.from_numpy(q).to(dev, dtype)
            kv, ki = T.dense_topk_pallas(d, qq, k=k)
            pv, pi = T.dense_topk_pallas(d, qq, k=k, plain=True)
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
        f"phase3 kernel B: {checks} cases (f32/bf16, k 10/32, k > n_docs, "
        f"duplicate scores) match the twin (scores atol {ATOL}, "
        f"{swaps} near-tie swaps < {TIE})"
    )


# ---------------------------------------------------------------------------
# Phase 4 + 5: the main path, then text requests
# ---------------------------------------------------------------------------


def build_main_path():
    """bench.py's corpus: the synthetic postings index, unit-norm embeddings
    stored as bf16 (converted by the port), and its query batch."""
    t0 = time.perf_counter()
    index = synthetic_postings_index(N_DOCS, vocab_size=VOCAB, seed=0)
    index.ensure_impact_order()
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((N_DOCS, DIM), dtype=np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    dense = convert.dense_index(emb, dtype=torch.bfloat16)
    retr = HybridRetriever(index, dense, device="cuda", device_batch=BATCH)
    total = BATCH * N_BATCHES
    ranks = np.exp(
        rng.uniform(np.log(50), np.log(VOCAB - 1), size=(total, 4))
    ).astype(np.int64)
    term_ids = [list(row + 1) for row in ranks]
    targets = rng.integers(0, N_DOCS, size=total)
    q = emb[targets] + 0.6 * rng.standard_normal((total, DIM)).astype(np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    prep = retr.prepare(term_ids, q, k=K, candidates_per_arm=C_ARM)
    torch.cuda.synchronize()
    log(
        f"setup: {N_DOCS} docs (nnz {index.nnz:,}) x {DIM} bf16, kernel="
        f"{retr.kernel}, plan width {prep.plan_doc_ids.shape[2]}, "
        f"{N_BATCHES} x {BATCH} queries ({time.perf_counter() - t0:.1f}s)"
    )
    if retr.kernel != "int8":
        raise AssertionError(f"auto-select gave {retr.kernel}, not int8")
    return retr, prep


def text_corpus():
    docs = synthetic_token_corpus(20_000, vocab_size=5_000, seed=3)
    queries = synthetic_queries_from_docs(docs, 12, seed=4) + [
        "t1 t2", "no such words here", ""
    ]
    return docs, queries


def exact_hybrid(retr, prep):
    """The hybrid with the exact dense arm (blocked f32 product over the
    stored rows, f32 queries): the reference recall is measured against."""
    out = []
    c = prep.candidates_per_arm
    for i in range(prep.queries.shape[0]):
        d_vals, d_ids = dense_topk_xla(retr.dense._rescore_emb, prep.queries[i], c)
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


def run(quick: bool) -> None:
    env = phase_environment()
    card = env["card"]
    phase_kernel_a()
    phase_kernel_b()
    if quick:
        log("quick run: phases 4-5 skipped")
        return

    retr, prep = build_main_path()
    docs, text_queries = text_corpus()

    # --- the counted window: the main path, then text requests ---
    T.reset_launch_counts()
    t0 = time.perf_counter()
    main_out = retr.run_prepared_device(prep)
    main_res = retr.finalize_prepared(prep, main_out)
    main_s = time.perf_counter() - t0
    after_main = T.launch_counts()
    text_retr = HybridRetriever.build(docs, device="cuda")
    text_res = text_retr.search(text_queries, k=K)
    counts = T.launch_counts()
    # --- end of the counted window ---

    # phase 4 checks
    n_q = BATCH * N_BATCHES
    assert after_main["i8_top2g"] == N_BATCHES, after_main
    assert after_main["fused_topk"] == 0, after_main
    ids, scores = main_res.ids, main_res.scores
    assert ids.shape == (n_q, K) and scores.shape == (n_q, K)
    assert np.isfinite(scores).all()
    assert ((ids >= -1) & (ids < N_DOCS)).all() and (ids[:, 0] >= 0).all()
    plain_res = retr.finalize_prepared(
        prep, retr.run_prepared_device(prep, plain=True)
    )
    swaps = near_tie_check(scores, ids, plain_res.scores, plain_res.ids)
    exact_equal = bool(
        np.array_equal(ids, plain_res.ids)
        and np.array_equal(scores, plain_res.scores)
    )
    recall = recall_at_k(ids, exact_hybrid(retr, prep))

    def batches():
        torch.cuda.synchronize()
        t = time.perf_counter()
        retr.run_prepared_device(prep)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / N_BATCHES

    def plain_batches():
        torch.cuda.synchronize()
        t = time.perf_counter()
        retr.run_prepared_device(prep, plain=True)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / N_BATCHES

    batches()  # warm
    per_batch = statistics.median(batches() for _ in range(15))
    plain_per_batch = statistics.median(plain_batches() for _ in range(3))
    log(
        f"phase4 main path: {n_q} queries in {main_s:.3f}s (first run), "
        f"kernel A launches {after_main['i8_top2g']}, results vs plain path: "
        f"exactly equal={exact_equal}, near-tie swaps {swaps}; recall@{K} vs "
        f"exact path {recall:.4f}; median per-batch (B={BATCH}) "
        f"{per_batch:.3f} ms with kernels, {plain_per_batch:.3f} ms with "
        f"twins [{card}]"
    )
    if recall < 0.95:
        raise AssertionError(f"recall@{K} {recall:.4f} < 0.95")

    # kernel A alone at the main path's shapes
    q8 = prep.queries_i8[0].contiguous()
    corpus = retr.dense._emb_device
    group = T.auto_i8_group(N_DOCS, C_ARM)
    sub = retr._dense_block_c(BATCH) // 128
    got = T.i8_top2g_cells(q8, corpus, group=group, sub=sub)
    want = T.i8_top2g_cells_plain(q8, corpus, group=group, sub=sub)
    a_err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    if a_err:
        raise AssertionError(f"kernel A differs from its twin by {a_err}")
    a_ms = cuda_ms(lambda: T.i8_top2g_cells(q8, corpus, group=group, sub=sub), 10)
    a_plain_ms = cuda_ms(
        lambda: T.i8_top2g_cells_plain(q8, corpus, group=group, sub=sub), 3
    )
    log(
        f"kernel A at B={BATCH}, N={N_DOCS}, D={DIM}, group={group}: "
        f"{a_ms:.3f} ms vs twin {a_plain_ms:.3f} ms [{card}]"
    )

    # phase 5 checks
    assert text_retr.kernel == "pallas", text_retr.kernel
    b_launches = counts["fused_topk"] - after_main["fused_topk"]
    assert b_launches >= 1, counts
    assert text_res.ids.shape == (len(text_queries), K)
    prep5 = text_retr.prepare(
        [encode_query(text_retr.bm25.index, s) for s in text_queries],
        text_retr.dense.embedder(text_queries), k=K,
    )
    plain5 = text_retr.finalize_prepared(
        prep5, text_retr.run_prepared_device(prep5, plain=True)
    )
    swaps5 = near_tie_check(text_res.scores, text_res.ids, plain5.scores, plain5.ids)
    qd = prep5.queries[0]
    rows = text_retr.dense._emb_device
    bv, bi = T.fused_topk(rows, qd, K)
    pv, pi = T.fused_topk_plain(rows, qd, K)
    b_err = float((bv - pv).abs().max())
    near_tie_check(bv.cpu(), bi.cpu(), pv.cpu(), pi.cpu(), atol=ATOL)
    b_ms = cuda_ms(lambda: T.fused_topk(rows, qd, K), 20)
    b_plain_ms = cuda_ms(lambda: T.fused_topk_plain(rows, qd, K), 20)
    log(
        f"phase5 text: {len(docs)} docs, {len(text_queries)} queries, kernel "
        f"B launches {b_launches}, results vs plain path near-tie swaps "
        f"{swaps5}; kernel B at B={qd.shape[0]}, N={len(docs)}, D={DIM} f32, "
        f"k={K}: {b_ms:.3f} ms vs twin {b_plain_ms:.3f} ms [{card}]"
    )

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    log(json.dumps({"kernels": [
        {
            "name": "i8_top2g", "route": "cuda",
            "source": "openintel_tpu_torch/csrc/i8_top2g.cu",
            "replaces": "openintel_tpu/ops/pallas/dense_topk.py:591",
            "launches": counts["i8_top2g"], "max_abs_err": a_err,
            "ms": a_ms, "plain_ms": a_plain_ms,
        },
        {
            "name": "fused_topk", "route": "cuda",
            "source": "openintel_tpu_torch/csrc/fused_topk.cu",
            "replaces": "openintel_tpu/ops/pallas/dense_topk.py:62",
            "launches": counts["fused_topk"], "max_abs_err": b_err,
            "ms": b_ms, "plain_ms": b_plain_ms,
        },
    ]}))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--quick", action="store_true",
        help="stop after the kernel build and the kernel-vs-twin checks",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    run(args.quick)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
