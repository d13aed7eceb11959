"""The sharded hybrid program's structural overhead on one device.

The port's counterpart of the reference's ``scripts/bench_sharded_overhead.py``.
The reference forced an 8-device virtual CPU platform; the port builds an
8-cell mesh over one device instead (``parallel/mesh.make_mesh`` over
``[device] * 8``, as ``chip_smoke.py`` phase 21 does on one card). The
cells run one after another, so the mesh cannot show a speed-up, but it
does show the structural cost of the sharded program (the per-shard
candidate lists gathered, the S-times-wider merges, the fusion over the
gathered pool, the per-shard plans) against the single-device program
doing the same scoring work. Three measurements over the same corpus,
batch 64, c = 32, ``kernel="xla"``:

  1. one device's ``HybridRetriever`` (``run_prepared``);
  2. ``sharded_hybrid_topk`` over the 8-cell mesh;
  3. a per-cell matmul + max, then the port's gather, against the same
     matmul on the whole corpus (does the mesh cost anything by itself?).

``overhead_ratio`` = t_sharded / t_single. Host clock around work that
ends in a device synchronise, best of the reps.

    python -m openintel_tpu_torch.tools.sharded_overhead [--device cpu] [--out PATH]

Env: OVH_DOCS (default 8 x 32,768).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from openintel_tpu_torch.index.schema import DenseIndex
from openintel_tpu_torch.index.synthetic import synthetic_postings_index
from openintel_tpu_torch.models.retrievers import HybridRetriever
from openintel_tpu_torch.parallel.mesh import make_mesh
from openintel_tpu_torch.parallel.retriever import shard_query_plans
from openintel_tpu_torch.parallel.sharded import _gather, shard_corpus, sharded_hybrid_topk
from openintel_tpu_torch.tools import common

N_SHARDS = 8
DIM, BATCH, K, C, VOCAB, REPS = 128, 64, 10, 32, 3000, 6


def overhead_inputs(n_total: int):
    """The reference's corpus and batch: postings from seed 2, unit rows and
    unit queries from ``default_rng(0)``, 4 random term ids a query."""
    rng = np.random.default_rng(0)
    idx = synthetic_postings_index(n_total, vocab_size=VOCAB, seed=2)
    idx.ensure_impact_order()
    emb = rng.standard_normal((n_total, DIM), dtype=np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    term_ids = [list(rng.integers(1, VOCAB, size=4)) for _ in range(BATCH)]
    q = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    return idx, emb, term_ids, q


def sharded_overhead(idx, emb, term_ids, q, device, *, reps: int) -> dict:
    """Time the three programs (best of ``reps`` after a warm-up); report
    whether the mesh's ids equal one device's (exact arms: equal but where
    two scores nearly tie, since each product may sum in its own order)."""

    def best_of(fn):
        fn()
        best = float("inf")
        for _ in range(reps):
            s = time.perf_counter()
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            best = min(best, time.perf_counter() - s)
        return best

    n_total = emb.shape[0]
    r1 = HybridRetriever(
        idx, DenseIndex.from_embeddings(emb), kernel="xla", device_batch=BATCH, device=device,
    )
    prep = r1.prepare(term_ids, q, k=K, candidates_per_arm=C)
    single = r1.run_prepared(prep)
    t_single = best_of(lambda: r1.run_prepared(prep))

    mesh = make_mesh(data=1, corpus=N_SHARDS, devices=[device] * N_SHARDS)
    pdi, pw, meta = shard_query_plans(idx, term_ids, N_SHARDS, max_postings_per_term=128)
    corpus = shard_corpus(mesh, torch.from_numpy(emb), "xla")
    qd = torch.from_numpy(q).to(device)
    pdid, pwd = torch.from_numpy(pdi).to(device), torch.from_numpy(pw).to(device)

    def run_sharded():
        return sharded_hybrid_topk(
            mesh, corpus, qd, pdid, pwd, K, candidates_per_arm=C,
            presorted=meta.presorted, max_run=meta.max_terms, block_size=4096,
        )

    t_sharded = best_of(run_sharded)
    ids_equal = bool(np.array_equal(run_sharded()[1].cpu().numpy(), single.ids))

    a = torch.from_numpy(emb).to(device)
    t_mm1 = best_of(lambda: (qd @ a.T).max(dim=1).values)

    def probe():
        return _gather(mesh, {
            cell: ((qd @ corpus.parts[cell].T).max(dim=1).values,) for cell in mesh.owned
        })

    t_mm8 = best_of(probe)
    gather_bytes = N_SHARDS * BATCH * C * 8  # per arm per batch: int32 ids + f32 scores
    return {
        "metric": "sharded_hybrid_structural_overhead",
        "platform": (
            f"{device.type}: {N_SHARDS} cells on one device (serialized: structure, "
            "not the interconnect)"
        ),
        "n_docs": n_total,
        "batch": BATCH,
        "candidates_per_arm": C,
        "t_single_1dev_ms": t_single * 1e3,
        "t_sharded_8dev_ms": t_sharded * 1e3,
        "overhead_ratio": t_sharded / t_single,
        "t_matmul_1dev_ms": t_mm1 * 1e3,
        "t_matmul_8cells_ms": t_mm8 * 1e3,
        "matmul_probe_ratio": t_mm8 / t_mm1,
        "allgather_bytes_per_batch_per_arm": gather_bytes,
        "allgather_bytes_per_query_per_arm": gather_bytes // BATCH,
        "ids_equal_single": ids_equal,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    common.add_device_flags(parser, "sharded_overhead")
    args = parser.parse_args(argv)
    device = common.tool_device(args.device)
    n_total = int(os.environ.get("OVH_DOCS", 0)) or N_SHARDS * 32_768
    res = {
        **sharded_overhead(*overhead_inputs(n_total), device, reps=REPS),
        **common.stamp(device),
    }
    common.write_json(res, args.out, "sharded_overhead")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
