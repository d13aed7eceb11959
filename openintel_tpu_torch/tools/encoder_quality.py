"""Encoder quality: the neural encoder against the hashing embedder.

The port's counterpart of the reference's ``scripts/encoder_quality.py``:
train the compact transformer encoder on a synthetic corpus with a
two-surface vocabulary (``index/synthetic.py::synthetic_synonym_corpus``),
then measure recall@10 and MRR@10 of every retriever arm (bm25, dense,
hybrid; hashing and neural embedders) on two query sets:

- exact:    queries reuse document-surface tokens (token overlap exists);
- mismatch: every query token uses the synonym surface that never occurs
            in any document (no token overlap by construction).

It also trains the cross-encoder reranker on the same corpus and measures
its MRR uplift over the first-stage hybrid ranking on the exact set. The
arms run ``kernel="xla"`` (the exact dense arm), as the reference's do.

    python -m openintel_tpu_torch.tools.encoder_quality [--n-docs 100000]
        [--steps 4000] [--rerank-steps 3000] [--ckpt-dir DIR] [--device cpu]

Resumable: the encoder checkpoint lands in ``--ckpt-dir`` (default
``build/tools/encoder_quality_ckpt``), in the reference's format, so a run
resumes in either package and completed steps are skipped. Writes the
tables to ``--out`` (default ``build/tools/encoder_quality.json``, or
``encoder_quality_template.json`` for ``--family template``) and prints the
markdown rows. ``--platform`` keeps the reference's spelling: ``cpu`` is
``--device cpu``, ``native`` the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from openintel_tpu_torch.index.synthetic import synthetic_synonym_corpus, synthetic_template_corpus
from openintel_tpu_torch.models.encoder import EncoderConfig, NeuralEmbedder
from openintel_tpu_torch.models.eval import evaluate_corpus, evaluate_retriever, synthetic_qrels
from openintel_tpu_torch.models.reranker import RerankedRetriever, train_reranker
from openintel_tpu_torch.models.retrievers import HybridRetriever
from openintel_tpu_torch.models.train import train_encoder
from openintel_tpu_torch.tools import common

CONFIG_KEYS = (
    "n_docs", "n_concepts", "steps", "batch", "lr", "dim", "depth", "heads", "vocab", "family",
)


def parse_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--n-docs", type=int, default=100_000)
    ap.add_argument("--n-concepts", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--rerank-steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--lr", type=float, default=1.5e-3)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=8192,
                    help="encoder hash-vocabulary size (8192 collides ~20%% of a "
                    "4000-surface vocabulary; 32768 cuts that to ~6%%)")
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument("--ckpt-dir", default=str(common.OUT_DIR / "encoder_quality_ckpt"))
    ap.add_argument("--family", choices=("synonym", "template"), default="synonym",
                    help="mismatch generator family: 1:1 synonym surfaces, or the "
                    "compositional two-token template phrases")
    ap.add_argument("--platform", choices=("cpu", "native"), default=None,
                    help="the reference's spelling of the device: cpu is --device cpu, "
                    "native the card")
    ap.add_argument("--rerank-only", action="store_true",
                    help="skip the retrieval tables (keep the existing JSON's) and "
                    "measure only the reranker uplift")
    common.add_device_flags(ap, "encoder_quality")
    args = ap.parse_args(argv)
    if args.platform is not None:
        args.device = "cpu" if args.platform == "cpu" else "cuda"
    return args


def encoder_quality(args, device, log, prior_tables=None) -> dict:
    """Train (or resume) the encoder, measure the six arms on both query
    sets (unless ``rerank_only``, which keeps ``prior_tables``), then train
    the reranker from the trained trunk and measure its uplift. ``args``
    carries the command's fields."""
    gen = synthetic_synonym_corpus if args.family == "synonym" else synthetic_template_corpus
    docs, syn = gen(args.n_docs, n_concepts=args.n_concepts, seed=41)
    log(f"corpus: {len(docs)} docs, {args.n_concepts} concepts ({args.family} family)")
    cfg = EncoderConfig(
        vocab_size=args.vocab, dim=args.dim, depth=args.depth, heads=args.heads, max_len=32,
    )
    t0 = time.perf_counter()
    res = train_encoder(
        docs, cfg, steps=args.steps, batch_size=args.batch, lr=args.lr, seed=42,
        synonym_map=syn, flip_p=0.5, ckpt_dir=args.ckpt_dir, ckpt_every=200,
        log=lambda m: log(f"train {m}"), device=device,
    )
    train_s = time.perf_counter() - t0
    log(
        f"encoder trained to step {res.step}"
        + (f", loss {res.losses[-1]:.3f}" if res.losses else " (resumed)")
    )
    emb = NeuralEmbedder(cfg, params=res.params, device=device)
    results: dict = {
        "config": {key: getattr(args, key) for key in CONFIG_KEYS},
        "encoder_step": res.step,
        "train_steps_run": len(res.losses),
        "train_s": train_s,
        "tables": dict(prior_tables or {}),
    }
    for dist, flip in () if args.rerank_only else (("exact", 0.0), ("mismatch", 1.0)):
        qrels = synthetic_qrels(
            docs, args.queries, seed=43, terms_per_query=4, synonym_map=syn, flip_p=flip,
        )
        rows = {}
        for label, embedder in (("hashing", None), ("neural", emb)):
            for r in evaluate_corpus(
                docs, qrels, k=10, modes=("bm25", "dense", "hybrid"), embedder=embedder,
                dim=args.dim, kernel="xla", device=device,
            ):
                rows[f"{label}-{r.mode}"] = {
                    "recall@10": round(r.recall_at_k, 4), "mrr@10": round(r.mrr_at_k, 4),
                }
                log(f"{dist:8s} {label}-{r.mode:6s}: R@10={r.recall_at_k:.3f} MRR={r.mrr_at_k:.3f}")
        results["tables"][dist] = rows

    # the reranker's uplift on the exact set: the first stage has signal to reorder
    rr, rr_losses = train_reranker(
        docs, cfg, steps=args.rerank_steps, k=4, batch_queries=8, lr=args.lr, seed=44,
        synonym_map=syn, flip_p=0.5, init_trunk=res.params, device=device,
    )
    log(f"reranker trained: loss {rr_losses[0]:.3f} -> {rr_losses[-1]:.3f}")
    qrels = synthetic_qrels(docs, args.queries, seed=43, terms_per_query=4)
    first = HybridRetriever.build(docs, dim=args.dim, kernel="xla", device=device)
    base = evaluate_retriever(first, qrels, k=10, mode="hybrid")
    rer = evaluate_retriever(RerankedRetriever(rr, first, docs), qrels, k=10, mode="hybrid")
    results["rerank_uplift_exact"] = {
        "first_stage_mrr@10": round(base.mrr_at_k, 4),
        "reranked_mrr@10": round(rer.mrr_at_k, 4),
        "first_stage_recall@10": round(base.recall_at_k, 4),
        "reranked_recall@10": round(rer.recall_at_k, 4),
    }
    log(
        f"rerank uplift (exact): MRR {base.mrr_at_k:.3f} -> {rer.mrr_at_k:.3f}, "
        f"R@10 {base.recall_at_k:.3f} -> {rer.recall_at_k:.3f}"
    )
    return results


def main(argv=None) -> int:
    args = parse_args(argv)
    device = common.tool_device(args.device)
    t0 = time.perf_counter()

    def log(msg: str) -> None:
        print(f"[{time.perf_counter() - t0:7.1f}s] {msg}", flush=True)

    log(common.device_line(device))
    name = "encoder_quality" if args.family == "synonym" else f"encoder_quality_{args.family}"
    out_path = Path(args.out) if args.out else common.OUT_DIR / f"{name}.json"
    prior = None
    if args.rerank_only and out_path.exists():
        prior = json.loads(out_path.read_text()).get("tables", {})
        log("rerank-only: retrieval tables carried from the existing JSON")
    results = {**common.stamp(device), **encoder_quality(args, device, log, prior)}
    log(f"wrote {common.write_json(results, str(out_path), name)}")
    print("\n| query set | retriever | recall@10 | MRR@10 |")
    print("|---|---|---|---|")
    for dist, rows in results["tables"].items():
        for label, m in rows.items():
            print(f"| {dist} | {label} | {m['recall@10']:.3f} | {m['mrr@10']:.3f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
