"""Phase profile of the C++ query planner at bench scale.

The port's counterpart of the reference's ``scripts/profile_planner.py``:
it reads the phase timers of the production planner (``plan_build_masked``'s
phase array, the one ``native_build_query_plan`` hangs on its ``planner``
span) over ``bench.py``'s query distribution (log-uniform term ranks
50..vocab over the seed-0 synthetic index) and prints the per-phase
breakdown of plan assembly:

  0 term-dedup+prune-check   1 pairwise-intersections   2 multi-selection
  3 per-term-emission        4 k-way-merge-output

and beside it the array's two counts: the queries whose pairwise hits
outgrew twice the multi-term budget, so that multi-selection grouped them
by doc, and the hits they grouped.

    python -m openintel_tpu_torch.tools.profile_planner [--device cpu] [--out PATH]

Env: PROF_DOCS (default 1_250_000), PROF_QUERIES (default 4096),
PROF_VOCAB (default 30_000), PROF_REPEATS (default 3, best-of),
PROF_TERMS (default 4; ``LO-HI`` draws each query's term count uniformly
from LO..HI, as the hybrid cell's ``3-9``),
PROF_BITMAP (0 off, 1 the production threshold, N > 1 an explicit
min_df), PROF_AB=1 (the no-bitmap planner in turns in the same process).
Single-threaded on purpose: the per-core rate is the serving budget unit.
The planner runs on the host; the default ``--device cuda`` only asserts
that the host is the card's (the rate item 9 weighs against its step).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
import time

import numpy as np

from openintel_tpu_torch import native
from openintel_tpu_torch.index.synthetic import synthetic_postings_index
from openintel_tpu_torch.models.retrievers import auto_prune_m
from openintel_tpu_torch.tools import common

PHASES = [
    "term-dedup+prune-check",
    "pairwise-intersections",
    "multi-selection",
    "per-term-emission",
    "k-way-merge-output",
]
COUNTS = ["multi_queries", "multi_hits"]
TERMS_PER_QUERY = 4


def parse_terms(spec: str) -> tuple[int, int]:
    """``"4"`` -> (4, 4); ``"3-9"`` -> (3, 9)."""
    lo, _, hi = spec.partition("-")
    lo, hi = int(lo), int(hi or lo)
    if not 1 <= lo <= hi:
        raise ValueError(f"PROF_TERMS={spec!r}: want N or LO-HI with 1 <= LO <= HI")
    return lo, hi


def bench_term_ids(
    total_q: int, vocab_size: int, terms: tuple[int, int] = (TERMS_PER_QUERY, TERMS_PER_QUERY)
) -> np.ndarray:
    """``bench.py``'s queries as term ids from ``default_rng(1)``: (total_q,
    HI) int32 for ``terms`` (LO, HI); a query of fewer than HI terms (a
    count uniform over LO..HI) ends in 0s, the padding term."""
    lo, hi = terms
    rng = np.random.default_rng(1)
    ranks = np.exp(
        rng.uniform(np.log(50), np.log(vocab_size - 1), size=(total_q, hi))
    ).astype(np.int64)
    q = ranks + 1
    if lo < hi:
        n = rng.integers(lo, hi + 1, size=total_q)
        q[np.arange(hi) >= n[:, None]] = 0
    return np.ascontiguousarray(q, dtype=np.int32)


def profile_plan(index, q: np.ndarray, lib, *, repeats: int, bitmap: int = 1, ab: bool = False) -> dict:
    """Plan ``q`` (``(Q, terms)`` int32 term ids) over ``index`` on one
    thread with the native library ``lib``, ``repeats`` times; returns the
    best run's ms per query, its phases' ms per query and shares of the
    instrumented time, its counts, and, with ``ab``, the bitmap and
    no-bitmap planners' best ms per query in turns."""
    n_docs = index.n_docs
    total_q, terms = q.shape
    prune_m = auto_prune_m(n_docs, 32) or 128  # small corpora: force pruning
    multi_budget = max(256, 32)
    p_offs, p_doc, p_imp = index.pruned_cache(prune_m)
    bm_slots = bm_words = None
    bm_stride = 0
    if bitmap:
        thr = bitmap if bitmap > 1 else max(8192, n_docs // 256)
        bm_slots, bm_words = index.bitmap_cache(thr)
        if bm_words is not None:
            bm_stride = bm_words.shape[1]
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    term_offsets = np.ascontiguousarray(index.term_offsets, dtype=np.int64)
    doc_ids = np.ascontiguousarray(index.doc_ids, dtype=np.int32)
    impact = np.ascontiguousarray(index.impact, dtype=np.float32)
    order = np.ascontiguousarray(index.ensure_impact_order(), dtype=np.int64)
    idf = np.ascontiguousarray(index.idf, dtype=np.float32)
    p_offs = np.ascontiguousarray(p_offs, dtype=np.int64)
    cap = int(terms * (prune_m + multi_budget))
    out_ids = np.full((total_q, cap), n_docs, dtype=np.int32)
    out_w = np.zeros((total_q, cap), dtype=np.float32)
    widths = np.zeros(total_q, dtype=np.int64)

    def run_once(slots, words, stride):
        ns = np.zeros(len(PHASES) + len(COUNTS), np.int64)
        s = time.perf_counter()
        rc = lib.plan_build_masked(
            term_offsets.ctypes.data_as(i64p), doc_ids.ctypes.data_as(i32p),
            impact.ctypes.data_as(f32p), order.ctypes.data_as(i64p),
            idf.ctypes.data_as(f32p), term_offsets.shape[0] - 1,
            q.ctypes.data_as(i32p), total_q, terms,
            prune_m, multi_budget, None,
            p_offs.ctypes.data_as(i64p), p_doc.ctypes.data_as(i32p),
            p_imp.ctypes.data_as(f32p),
            slots.ctypes.data_as(i32p) if slots is not None else None,
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)) if words is not None else None,
            stride,
            out_ids.ctypes.data_as(i32p), out_w.ctypes.data_as(f32p),
            cap, widths.ctypes.data_as(i64p), 1, ns.ctypes.data_as(i64p),
        )
        wall = time.perf_counter() - s
        if rc < 0:
            raise RuntimeError(f"plan_build_masked failed ({rc})")
        return wall, [int(x) for x in ns]

    out = {
        "n_docs": n_docs, "nnz": int(index.nnz), "queries": total_q, "prune_m": prune_m,
        "bitmaps": None if bm_words is None else list(bm_words.shape), "repeats": repeats,
    }
    # the interleaved control arm: ambient drift hits both planners alike
    if ab and bm_words is not None:
        best_on = best_off = float("inf")
        for _ in range(repeats):
            best_on = min(best_on, run_once(bm_slots, bm_words, bm_stride)[0])
            best_off = min(best_off, run_once(None, None, 0)[0])
        out["ab_ms_per_query"] = {
            "bitmaps": best_on * 1e3 / total_q, "off": best_off * 1e3 / total_q,
        }
    best_wall, best_ns = float("inf"), None
    for _ in range(repeats):
        wall, ns = run_once(bm_slots, bm_words, bm_stride)
        if wall < best_wall:
            best_wall, best_ns = wall, ns
    best_ns, counts = best_ns[: len(PHASES)], best_ns[len(PHASES):]
    tot = sum(best_ns) or 1
    out.update({
        "ms_per_query": best_wall * 1e3 / total_q,
        "width_max": int(widths.max()),
        "phases": {
            name: {"ms_per_query": ns / 1e6 / total_q, "share": ns / tot}
            for name, ns in zip(PHASES, best_ns)
        },
        "uninstrumented_ms_per_query": (best_wall * 1e9 - tot) / 1e6 / total_q,
        **dict(zip(COUNTS, counts)),
    })
    return out


def report_lines(res: dict) -> list[str]:
    """The script's printed breakdown."""
    lines = []
    if "ab_ms_per_query" in res:
        on, off = res["ab_ms_per_query"]["bitmaps"], res["ab_ms_per_query"]["off"]
        lines.append(
            f"A/B interleaved: bitmaps {on:.4f} vs off {off:.4f} ms/query/core ({off / on:.2f}x)"
        )
    lines.append(
        f"plan assembly: {res['ms_per_query']:.4f} ms/query/core (best of "
        f"{res['repeats']}, {res['queries']} queries, width max {res['width_max']})"
    )
    for name, ph in res["phases"].items():
        lines.append(
            f"  {name:24s} {ph['ms_per_query']:8.4f} ms/q  "
            f"{100 * ph['share']:5.1f}% of instrumented"
        )
    lines.append(f"  {'(uninstrumented rest)':24s} {res['uninstrumented_ms_per_query']:8.4f} ms/q")
    grouped, hits = res["multi_queries"], res["multi_hits"]
    lines.append(
        f"  grouped by doc: {grouped} of {res['queries']} queries, {hits:,} hits"
        f" ({hits / max(grouped, 1):,.0f} a grouped query)"
    )
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    common.add_device_flags(parser, "profile_planner")
    args = parser.parse_args(argv)
    device = common.tool_device(args.device)
    n_docs = int(os.environ.get("PROF_DOCS", 0)) or 1_250_000
    total_q = int(os.environ.get("PROF_QUERIES", 0)) or 4096
    vocab_size = int(os.environ.get("PROF_VOCAB", 0)) or 30_000
    repeats = int(os.environ.get("PROF_REPEATS", 0)) or 3
    terms = parse_terms(os.environ.get("PROF_TERMS", "") or str(TERMS_PER_QUERY))
    stamp = common.stamp(device)
    print(common.device_line(device), flush=True)
    t0 = time.perf_counter()
    index = synthetic_postings_index(n_docs, vocab_size=vocab_size, seed=0)
    index.ensure_impact_order()
    index_s = time.perf_counter() - t0
    native.build()
    lib = native._load()
    if lib is None:
        raise RuntimeError(f"the native planner {native.library_path()} does not load")
    res = profile_plan(
        index, bench_term_ids(total_q, vocab_size, terms), lib, repeats=repeats,
        bitmap=int(os.environ.get("PROF_BITMAP", "1")), ab=os.environ.get("PROF_AB") == "1",
    )
    print(
        f"index: {n_docs} docs nnz={res['nnz']:,} prune_m={res['prune_m']} "
        f"bitmaps={'off' if res['bitmaps'] is None else tuple(res['bitmaps'])} "
        f"({index_s:.1f}s)",
        flush=True,
    )
    for line in report_lines(res):
        print(line, flush=True)
    res = {
        "metric": "planner_phase_profile", **stamp, "host_cores": os.cpu_count(),
        "vocab_size": vocab_size, "terms": list(terms), "index_s": index_s, **res,
    }
    print(f"wrote {common.write_json(res, args.out, 'profile_planner')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
