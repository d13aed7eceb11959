"""Fusion A/B: RRF (an rrf_k sweep) against the z-normalised score blend
(an alpha sweep).

The port's counterpart of the reference's ``scripts/fusion_ab.py``: each
arm is a ``HybridRetriever(..., fusion=..., kernel="xla")`` on the quality
harness (``models/eval.py``), measured per query set (exact and
vocabulary-mismatch) and per arm-quality regime (the hashing embedder
always; a trained neural encoder when ``--encoder`` names a checkpoint of
either package). Every arm keeps the same candidate width, so the A/B
isolates the fusion function, not the pool size.

    python -m openintel_tpu_torch.tools.fusion_ab [--n-docs 20000]
        [--queries 400] [--encoder CKPT_DIR] [--device cpu] [--out PATH]

Writes the tables to ``--out`` (default ``build/tools/fusion_ab.json``)
and prints the markdown rows.
"""

from __future__ import annotations

import argparse
import sys
import time

from openintel_tpu_torch.index.build import build_postings_index
from openintel_tpu_torch.index.schema import DenseIndex
from openintel_tpu_torch.index.synthetic import synthetic_synonym_corpus
from openintel_tpu_torch.models.embedding import HashingEmbedder
from openintel_tpu_torch.models.eval import evaluate_retriever, synthetic_qrels
from openintel_tpu_torch.models.retrievers import HybridRetriever
from openintel_tpu_torch.models.train import load_embedder
from openintel_tpu_torch.tools import common

ARMS = (
    ("rrf", {"rrf_k": 20.0}),
    ("rrf", {"rrf_k": 60.0}),
    ("rrf", {"rrf_k": 120.0}),
    ("zblend", {"blend_alpha": 0.3}),
    ("zblend", {"blend_alpha": 0.5}),
    ("zblend", {"blend_alpha": 0.7}),
)


def arm_label(fusion: str, kw: dict) -> str:
    if fusion == "rrf":
        return f"rrf(k={int(kw['rrf_k'])})"
    return f"zblend(a={kw['blend_alpha']})"


class FixedCandidates:
    """Pins ``candidates_per_arm`` so the harness's 2k default and its
    hybrid detection do not vary across arms."""

    def __init__(self, inner, c: int):
        self._inner, self._c = inner, c

    def search(self, queries, k=10, **kw):
        kw.pop("candidates_per_arm", None)
        kw.pop("mode", None)  # hybrid only; the inner search has no modes
        return self._inner.search(queries, k=k, candidates_per_arm=self._c, **kw)


def fusion_tables(docs, qsets: dict, regimes, *, candidates: int, device, log) -> dict:
    """Per regime (label, embedder) and fusion arm, recall@10 and MRR@10 on
    each query set of ``qsets`` (label -> qrels)."""
    postings = build_postings_index(docs)
    tables: dict = {}
    for regime, embedder in regimes:
        dense = DenseIndex.from_embeddings(embedder(list(docs)))
        rows: dict = {}
        for fusion, kw in ARMS:
            r = HybridRetriever(
                postings, dense, embedder, fusion=fusion, kernel="xla", device=device, **kw
            )
            label = arm_label(fusion, kw)
            for dist, qrels in qsets.items():
                res = evaluate_retriever(FixedCandidates(r, candidates), qrels, k=10, mode="hybrid")
                rows.setdefault(label, {})[dist] = {
                    "recall@10": round(res.recall_at_k, 4), "mrr@10": round(res.mrr_at_k, 4),
                }
                log(
                    f"{regime:7s} {label:14s} {dist:8s}: "
                    f"R@10={res.recall_at_k:.3f} MRR={res.mrr_at_k:.3f}"
                )
        tables[regime] = rows
    return tables


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--n-docs", type=int, default=20_000)
    ap.add_argument("--n-concepts", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=400)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--candidates", type=int, default=20,
                    help="candidates per arm (2*k, the serving default)")
    ap.add_argument("--encoder", default=None,
                    help="trained encoder checkpoint dir (adds the neural regime; "
                    "hashing always runs)")
    common.add_device_flags(ap, "fusion_ab")
    args = ap.parse_args(argv)
    device = common.tool_device(args.device)
    t0 = time.perf_counter()

    def log(msg: str) -> None:
        print(f"[{time.perf_counter() - t0:6.1f}s] {msg}", flush=True)

    log(common.device_line(device))
    docs, syn = synthetic_synonym_corpus(args.n_docs, n_concepts=args.n_concepts, seed=41)
    log(f"corpus: {len(docs)} docs, {args.n_concepts} concepts")
    regimes = [("hashing", HashingEmbedder(dim=args.dim))]
    if args.encoder:
        regimes.append(("neural", load_embedder(args.encoder, device=device)))
        log(f"neural regime: encoder from {args.encoder}")
    qsets = {
        "exact": synthetic_qrels(docs, args.queries, seed=43, terms_per_query=4),
        "mismatch": synthetic_qrels(
            docs, args.queries, seed=43, terms_per_query=4, synonym_map=syn, flip_p=1.0,
        ),
    }
    results = {
        "config": {
            key: getattr(args, key) for key in ("n_docs", "n_concepts", "queries", "dim", "candidates")
        },
        **common.stamp(device),
        "tables": fusion_tables(
            docs, qsets, regimes, candidates=args.candidates, device=device, log=log
        ),
    }
    log(f"wrote {common.write_json(results, args.out, 'fusion_ab')}")
    print("\n| regime | fusion | exact R@10 | exact MRR | mismatch R@10 | mismatch MRR |")
    print("|---|---|---|---|---|---|")
    for regime, rows in results["tables"].items():
        for label, m in rows.items():
            e, mm = m["exact"], m["mismatch"]
            print(
                f"| {regime} | {label} | {e['recall@10']:.3f} | {e['mrr@10']:.3f} "
                f"| {mm['recall@10']:.3f} | {mm['mrr@10']:.3f} |"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
