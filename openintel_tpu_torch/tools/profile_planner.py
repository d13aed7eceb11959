"""Phase profile of the C++ query planner at bench scale.

The port's counterpart of the reference's ``scripts/profile_planner.py``:
it builds a ``-DOPENINTEL_PROFILE`` variant of the port's own ``native/``
sources into the ignored ``build/openintel_tpu_torch/`` (named apart from
the production library, which carries no instrumentation), replays
``bench.py``'s query distribution (log-uniform term ranks 50..vocab over
the seed-0 synthetic index) and prints the per-phase breakdown of plan
assembly:

  0 term-dedup+prune-check   1 pairwise-intersections   2 multi-selection
  3 per-term-emission        4 k-way-merge-output

    python -m openintel_tpu_torch.tools.profile_planner [--device cpu] [--out PATH]

Env: PROF_DOCS (default 1_250_000), PROF_QUERIES (default 4096),
PROF_VOCAB (default 30_000), PROF_REPEATS (default 3, best-of),
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
import subprocess
import sys
import time
from pathlib import Path

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
TERMS_PER_QUERY = 4


def profile_library_path() -> Path:
    """The profile variant's library, named by the sources' hash beside
    (never over) the production one."""
    return native.BUILD_DIR / f"libopenintel_native_profile_{native._src_hash()[:16]}.so"


def build_profile_lib() -> ctypes.CDLL:
    """Compile (unless built) and bind the ``-DOPENINTEL_PROFILE`` variant."""
    so = profile_library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-DOPENINTEL_PROFILE",
             f'-DOPENINTEL_SRC_HASH="{native._src_hash()}"']
            + [str(s) for s in native._SRCS]
            + ["-o", str(tmp)],
            check=True, capture_output=True,
        )
        os.replace(tmp, so)
    lib = native._bind(ctypes.CDLL(str(so)))
    lib.planner_prof_reset.restype = None
    lib.planner_prof_reset.argtypes = []
    lib.planner_prof_read.restype = None
    lib.planner_prof_read.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong]
    return lib


def bench_term_ids(total_q: int, vocab_size: int) -> np.ndarray:
    """``bench.py``'s queries as term ids: (total_q, 4) int32 from
    ``default_rng(1)``."""
    rng = np.random.default_rng(1)
    ranks = np.exp(
        rng.uniform(np.log(50), np.log(vocab_size - 1), size=(total_q, TERMS_PER_QUERY))
    ).astype(np.int64)
    return np.ascontiguousarray(ranks + 1, dtype=np.int32)


def profile_plan(index, q: np.ndarray, lib, *, repeats: int, bitmap: int = 1, ab: bool = False) -> dict:
    """Plan ``q`` (``(Q, terms)`` int32 term ids) over ``index`` on one
    thread with the profile library ``lib``, ``repeats`` times; returns the
    best run's ms per query, its phases' ms per query and shares of the
    instrumented time, and, with ``ab``, the bitmap and no-bitmap planners'
    best ms per query in turns."""
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
        lib.planner_prof_reset()
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
            cap, widths.ctypes.data_as(i64p), 1,
        )
        wall = time.perf_counter() - s
        if rc < 0:
            raise RuntimeError(f"plan_build_masked failed ({rc})")
        ns = (ctypes.c_longlong * len(PHASES))()
        lib.planner_prof_read(ns, len(PHASES))
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
    tot = sum(best_ns) or 1
    out.update({
        "ms_per_query": best_wall * 1e3 / total_q,
        "width_max": int(widths.max()),
        "phases": {
            name: {"ms_per_query": ns / 1e6 / total_q, "share": ns / tot}
            for name, ns in zip(PHASES, best_ns)
        },
        "uninstrumented_ms_per_query": (best_wall * 1e9 - tot) / 1e6 / total_q,
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
    stamp = common.stamp(device)
    print(common.device_line(device), flush=True)
    t0 = time.perf_counter()
    index = synthetic_postings_index(n_docs, vocab_size=vocab_size, seed=0)
    index.ensure_impact_order()
    index_s = time.perf_counter() - t0
    lib = build_profile_lib()
    res = profile_plan(
        index, bench_term_ids(total_q, vocab_size), lib, repeats=repeats,
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
        "vocab_size": vocab_size, "index_s": index_s, **res,
    }
    print(f"wrote {common.write_json(res, args.out, 'profile_planner')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
