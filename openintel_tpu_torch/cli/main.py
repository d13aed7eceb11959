"""CLI entry point of the port (reference: src/cli/args.rs, src/main.rs).

    python -m openintel_tpu_torch.cli.main analyze TICKER [--offline] [--analyzer CKPT_DIR]
    python -m openintel_tpu_torch.cli.main scan T1 T2 ... [--offline]
    python -m openintel_tpu_torch.cli.main compare T1 T2 ... [--rank-by crowding] [--offline]
    python -m openintel_tpu_torch.cli.main pulse TICKER [--accounts A ...] [--keywords K ...]
    python -m openintel_tpu_torch.cli.main risk T1 [T2 ...] --budget USD [--offline]
    python -m openintel_tpu_torch.cli.main train CORPUS --out CKPT_DIR [--reranker] [--analyzer]
    python -m openintel_tpu_torch.cli.main index CORPUS --out PREFIX [--encoder CKPT_DIR]
    python -m openintel_tpu_torch.cli.main search "query" --index PREFIX [--encoder CKPT_DIR] [--rerank CKPT_DIR] [--mesh SPEC]
    python -m openintel_tpu_torch.cli.main evaluate CORPUS [--queries QRELS] [--rerank CKPT_DIR]
    python -m openintel_tpu_torch.cli.main doctor [--index PREFIX]
    python -m openintel_tpu_torch.cli.main setup {reddit,bluesky,x} [--forget] [--verify]
    python -m openintel_tpu_torch.cli.main mcp [--offline] [--index PREFIX] [--encoder CKPT_DIR] [--rerank CKPT_DIR] [--mesh SPEC] [--updatable]

``search``, ``index`` and ``mcp`` also take the multi-process flags
``--coordinator HOST:PORT --num-processes N --process-id I``
(``parallel.distributed``), which start the process group before any
device use.

The port's copy of :mod:`openintel_tpu.cli.main`, with the same flags,
error messages, output and exit codes, over the same on-disk index pair
and checkpoints. ``--offline`` wires the deterministic fixture sources +
mock market, the only mode that works without network egress. Where the
reference runs a device program (the lexicon from 512 posts, the neural
analyzer, the one ``aggregate_batch`` of a scan or compare, a
multi-ticker risk screen's ATR, the retrieval paths), the port runs it on
the card; ``--device cpu`` (the port's counterpart of the reference's
``JAX_PLATFORMS=cpu``) runs it on the host. Without a card and without
``--device cpu``, such a command fails with CUDA's own error: nothing
moves to the CPU quietly. ``pulse``, ``setup`` and a one-ticker ``risk``
touch no device, as in the reference. ``train --mesh DxM`` trains over
the first D·M devices of ``--device`` (the cards there are; on the CPU the
host stands in for as many as asked), data parallel over D and tensor
parallel over M.
"""

from __future__ import annotations

import argparse
import asyncio
import datetime as dt
import json
import sys
from pathlib import Path
from typing import Optional

KERNEL_CHOICES = ["auto", "xla", "pallas", "fast", "int8", "int4"]

def _add_device_flag(p: argparse.ArgumentParser, what: str = "the index is served") -> None:
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help=f"where {what} (default cuda, the card; cpu runs the plain "
        "versions on the host)",
    )


def _wire(offline: bool):
    """-> (social_sources, market_source, bar_source, credentials)."""
    if offline:
        from openintel_tpu_torch.sources.fixtures import MockMarketSource, fixture_social
        from openintel_tpu_torch.sources.yahoo import FixtureBars

        return fixture_social(), MockMarketSource(), FixtureBars(), None

    from openintel_tpu_torch.config.secrets import Credentials
    from openintel_tpu_torch.config.store import KeychainStore
    from openintel_tpu_torch.sources import build_social_sources
    from openintel_tpu_torch.sources.yahoo import YahooMarketSource

    creds = Credentials.load(KeychainStore())
    market = YahooMarketSource()
    return build_social_sources(creds), market, market, creds


def _add_source_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--reddit", action="store_true", help="enable only Reddit")
    p.add_argument("--bluesky", action="store_true", help="enable only Bluesky")
    p.add_argument("--no-market", action="store_true", help="skip the market snapshot")
    p.add_argument("--limit", type=int, default=50, help="posts per source (default 50)")
    p.add_argument(
        "--format", choices=["table", "json"], default="table", help="output format"
    )
    p.add_argument(
        "--offline",
        action="store_true",
        help="use deterministic fixture sources + mock market (no network)",
    )


def _distributed_flags(p: argparse.ArgumentParser) -> None:
    from openintel_tpu_torch.parallel.distributed import add_distributed_flags

    add_distributed_flags(p)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="openintel-torch",
        description=(
            "OpenIntel on PyTorch — fuses social sentiment with market action "
            "into a speculation report; hybrid retrieval (BM25 + dense "
            "cosine) on an NVIDIA GPU inside."
        ),
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("analyze", help="analyze one ticker")
    p.add_argument(
        "--analyzer", default=None, metavar="CKPT_DIR",
        help="score posts with a trained neural analyzer instead of the lexicon",
    )
    p.add_argument("ticker")
    _add_source_flags(p)
    _add_device_flag(p, "posts are scored (512 and more; the analyzer always)")

    p = sub.add_parser("scan", help="analyze a watchlist concurrently")
    p.add_argument("tickers", nargs="+")
    _add_source_flags(p)
    _add_device_flag(p, "the watchlist aggregates")

    p = sub.add_parser("compare", help="compare tickers ranked by a signal")
    p.add_argument("tickers", nargs="+")
    p.add_argument(
        "--rank-by",
        choices=["crowding", "speculation_index", "net_sentiment", "divergence"],
        default="crowding",
    )
    _add_source_flags(p)
    _add_device_flag(p, "the tickers aggregate")

    p = sub.add_parser("pulse", help="paid X catalyst feed (cost-accounted)")
    p.add_argument("ticker")
    p.add_argument("--accounts", nargs="*", default=[], help="X handles (no @)")
    p.add_argument("--keywords", nargs="*", default=[], help="company-language terms")
    p.add_argument("--hours", type=int, default=24, help="lookback hours (max 167)")
    p.add_argument("--limit", type=int, default=20, help="max posts (max 100)")
    p.add_argument("--format", choices=["table", "json"], default="table")

    p = sub.add_parser("risk", help="ATR(14) risk calculator — never advice")
    p.add_argument(
        "ticker", nargs="+",
        help="one ticker (full frame) or several (batch screen: one device "
        "ATR call for the whole list)",
    )
    p.add_argument("--budget", type=float, required=True, help="risk budget USD")
    p.add_argument("--direction", choices=["long", "short"], default="long")
    p.add_argument("--stop-multiple", type=float, default=None)
    p.add_argument("--entry", type=float, default=None)
    p.add_argument("--format", choices=["table", "json"], default="table")
    p.add_argument("--offline", action="store_true", help="use fixture bars")
    _add_device_flag(p, "a screen of several tickers computes its ATR")

    p = sub.add_parser("search", help="hybrid retrieval over an indexed corpus")
    p.add_argument("query", nargs="+", help="one or more queries")
    p.add_argument("--index", required=True, help="index path prefix (from `index`)")
    p.add_argument("-k", type=int, default=10)
    p.add_argument(
        "--mode", choices=["hybrid", "bm25", "dense"], default="hybrid"
    )
    p.add_argument("--format", choices=["table", "json"], default="table")
    p.add_argument(
        "--encoder", default=None,
        help="embed queries with a trained encoder checkpoint dir",
    )
    p.add_argument(
        "--rerank", default=None,
        help="re-score the top candidates with a cross-encoder checkpoint dir",
    )
    p.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help="serve over a device mesh: corpus shards ('8') or "
        "data x corpus ('2x4'); requires that many devices",
    )
    p.add_argument(
        "--kernel", choices=KERNEL_CHOICES, default="auto",
        help="dense-arm kernel (auto = int8 candidates + exact rescore at "
        "100k docs and more, the fused exact kernel below, on the card; "
        "xla on the CPU)",
    )
    p.add_argument(
        "--fusion", choices=["zblend", "rrf"], default="zblend",
        help="hybrid arm fusion: zblend (z-normalised score blend) or rrf "
        "(rank-only reciprocal-rank fusion)",
    )
    p.add_argument(
        "--blend-alpha", type=float, default=None, metavar="A",
        help="zblend lexical weight (default 0.7; dense gets 1-A)",
    )
    p.add_argument(
        "--include-ids", default=None, metavar="IDS",
        help="filtered search: only rank these doc ids "
        "(comma list, ranges ok: '3,10-20,512')",
    )
    p.add_argument(
        "--exclude-ids", default=None, metavar="IDS",
        help="filtered search: never rank these doc ids "
        "(comma list, ranges ok; composes with --include-ids)",
    )
    _distributed_flags(p)
    _add_device_flag(p)

    p = sub.add_parser("index", help="build a hybrid index from a corpus file")
    p.add_argument("corpus", help="text file, one document per line")
    p.add_argument("--out", required=True, help="output path prefix")
    p.add_argument("--dim", type=int, default=384, help="embedding dim")
    p.add_argument(
        "--dense-store", choices=["f32", "bf16"], default=None,
        help="dense embedding storage precision: f32 (default; "
        "recall-critical deployments) or bf16 (half the index memory)",
    )
    p.add_argument(
        "--bf16", action="store_true",
        help="alias for --dense-store bf16 (kept for compatibility)",
    )
    p.add_argument(
        "--encoder", default=None,
        help="embed with a trained encoder checkpoint dir (from `train`)",
    )
    p.add_argument(
        "--resume-dir", default=None,
        help="checkpoint-restart build: chunk checkpoints live here; "
        "re-running resumes after interruption",
    )
    p.add_argument(
        "--append", action="store_true",
        help="add CORPUS's docs to the EXISTING index at --out (ids stay "
        "stable; statistics recomputed over the combined corpus) instead "
        "of rebuilding from scratch",
    )
    p.add_argument("--chunk-docs", type=int, default=10_000)
    _distributed_flags(p)
    _add_device_flag(p)

    p = sub.add_parser("train", help="contrastively train the neural encoder")
    p.add_argument("corpus", help="text file, one document per line")
    p.add_argument("--out", required=True, help="checkpoint directory (resumable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--synonyms", default=None, metavar="TSV",
        help="token<TAB>synonym pairs: train under vocabulary mismatch "
        "(query tokens substitute their synonym surface with --flip-p "
        "probability)",
    )
    p.add_argument(
        "--flip-p", type=float, default=0.5,
        help="per-token synonym substitution probability (with --synonyms)",
    )
    p.add_argument(
        "--reranker", action="store_true",
        help="also train a cross-encoder reranker into the checkpoint dir "
        "(trunk warm-started from the just-trained encoder)",
    )
    p.add_argument(
        "--analyzer", action="store_true",
        help="also distill the lexicon analyzer into a neural head",
    )
    p.add_argument(
        "--mesh", default=None, metavar="DxM",
        help="train over a device mesh: data x model ('2x4'); params go "
        "tensor-parallel (Megatron split) over the model axis, batches "
        "data-parallel; requires that many devices",
    )
    _add_device_flag(p, "the encoder trains")

    p = sub.add_parser(
        "evaluate", help="retrieval quality (recall@k / MRR) against labels"
    )
    p.add_argument("corpus", help="text file, one document per line")
    p.add_argument(
        "--queries", default=None,
        help="TSV labels: query<TAB>doc_id[<TAB>doc_id...]; omit for a "
        "self-labeled synthetic eval",
    )
    p.add_argument("--n-synthetic", type=int, default=200,
                   help="synthetic queries when --queries is omitted")
    p.add_argument("-k", type=int, default=10)
    p.add_argument(
        "--mode", choices=["all", "hybrid", "bm25", "dense"], default="all"
    )
    p.add_argument("--encoder", default=None,
                   help="embed with a trained encoder checkpoint dir")
    p.add_argument(
        "--rerank", default=None, metavar="CKPT",
        help="also evaluate the two-stage path (hybrid top-2k -> "
        "cross-encoder blend rerank -> top-k) with this reranker "
        "checkpoint dir, reported as the 'rerank' row next to the "
        "first-stage rows — the uplift measurement",
    )
    p.add_argument("--dim", type=int, default=384)
    p.add_argument(
        "--kernel", choices=KERNEL_CHOICES, default="auto",
        help="dense-arm kernel to evaluate (auto = the served default)",
    )
    p.add_argument("--format", choices=["table", "json"], default="table")
    _add_device_flag(p, "the retrievers and the reranker run")

    p = sub.add_parser(
        "doctor", help="environment diagnostics (card, native tier, CUDA kernels)"
    )
    p.add_argument(
        "--index", default=None,
        help="also validate an index checkpoint pair (path prefix)",
    )
    _add_device_flag(p, "the commands will run")

    p = sub.add_parser("setup", help="guided credential setup with live verify")
    p.add_argument("source", choices=["reddit", "bluesky", "x"])
    p.add_argument("--forget", action="store_true", help="delete stored credentials")
    p.add_argument(
        "--verify", action="store_true",
        help="non-interactively probe resolved (env/keychain) credentials "
        "and exit 0 iff they work (CI-friendly)",
    )

    p = sub.add_parser("mcp", help="serve the MCP tool surface over stdio")
    p.add_argument("--offline", action="store_true")
    p.add_argument(
        "--index", default=None,
        help="index path prefix (from `index`): adds the search_corpus tool",
    )
    p.add_argument("--encoder", default=None, help="trained encoder checkpoint dir")
    p.add_argument(
        "--rerank", default=None,
        help="cross-encoder checkpoint dir: search_corpus gains a rerank stage",
    )
    p.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help="serve search_corpus over a device mesh ('8' or '2x4')",
    )
    p.add_argument(
        "--kernel", choices=KERNEL_CHOICES, default="auto",
        help="dense-arm kernel for search_corpus",
    )
    p.add_argument(
        "--updatable", action="store_true",
        help="serve a mutable corpus: adds the index_documents / "
        "delete_documents / compact_corpus tools (incremental delta + "
        "tombstones; composes with --mesh for sharded live serving)",
    )
    _distributed_flags(p)
    _add_device_flag(p, "the index is served and the analysis tools aggregate")
    return parser


def sharded_kernel_name(kernel: Optional[str]) -> Optional[str]:
    """Map the single-device kernel names onto the sharded component's
    ("fast" is called "pallas_fast" there; the rest coincide)."""
    return "pallas_fast" if kernel == "fast" else kernel


def read_corpus(path: str) -> list[str]:
    """A corpus file's documents: one a line, stripped, blank lines
    skipped."""
    return [line.strip() for line in Path(path).read_text().splitlines() if line.strip()]


def run_analyze(args) -> tuple[str, int]:
    from openintel_tpu_torch.application import analyze
    from openintel_tpu_torch.application.request import AnalysisRequest
    from openintel_tpu_torch.cli import render
    from openintel_tpu_torch.config.settings import AppConfig, OutputFormat

    social, market, _, _ = _wire(args.offline)
    config = AppConfig.new(
        args.ticker,
        args.reddit,
        args.bluesky,
        args.no_market,
        args.limit,
        OutputFormat(args.format),
    )
    req = AnalysisRequest(
        ticker=config.ticker,
        enabled_sources=config.enabled_sources,
        market_enabled=config.market_enabled,
        limit=config.limit,
        engine=config.engine,
    )
    analyzer = None
    if args.analyzer:
        from openintel_tpu_torch.models.neural_analyzer import load_analyzer

        analyzer = load_analyzer(args.analyzer, device=args.device)
    try:
        report = asyncio.run(
            analyze(req, social, market, analyzer=analyzer, device=args.device)
        )
    except Exception as e:
        return f"error: {e}", 1
    if config.format is OutputFormat.JSON:
        return render.render_report_json(report), 0
    return render.render_report_table(report), 0


def _mcp_args(args, tickers=None) -> dict:
    out = {
        "enable_reddit": args.reddit or None,
        "enable_bluesky": args.bluesky or None,
        "no_market": args.no_market or None,
        "limit": args.limit,
    }
    if tickers is not None:
        out["tickers"] = tickers
    return out


def run_scan(args) -> tuple[str, int]:
    from openintel_tpu_torch.cli import render
    from openintel_tpu_torch.mcp import tools

    social, market, _, _ = _wire(args.offline)
    out = asyncio.run(
        tools.run_scan(_mcp_args(args, args.tickers), social, market, args.device)
    )
    if args.format == "json":
        return render.render_json(out), 0
    lines = []
    for entry in out["entries"]:
        if "error" in entry:
            lines.append(f"{entry['ticker']}: error — {entry['error']}")
        else:
            r = entry["report"]
            lines.append(
                f"{entry['ticker']}: {r['fusion']['alignment']} · "
                f"crowding {r['fusion']['crowding'] * 100:.0f}% · "
                f"{r['social']['total_mentions']} mentions"
            )
    lines += ["", out["disclaimer"]]
    return "\n".join(lines) + "\n", 0


def run_compare(args) -> tuple[str, int]:
    from openintel_tpu_torch.cli import render
    from openintel_tpu_torch.mcp import tools

    social, market, _, _ = _wire(args.offline)
    targs = _mcp_args(args, args.tickers)
    targs["rank_by"] = args.rank_by
    out = asyncio.run(tools.run_compare(targs, social, market, args.device))
    if args.format == "json":
        return render.render_json(out), 0
    lines = [f"rank by: {out['rank_by']}"]
    for i, e in enumerate(out["ranked"], 1):
        r = e["report"]
        lines.append(
            f"{i}. {e['ticker']} — metric {e['rank_metric']:.3f} · "
            f"{r['fusion']['alignment']}"
        )
    for err in out["errors"]:
        lines.append(f"x. {err['ticker']} — error: {err['error']}")
    lines += ["", out["disclaimer"]]
    return "\n".join(lines) + "\n", 0


def run_pulse(args) -> tuple[str, int]:
    from openintel_tpu_torch.application.pulse import pulse as pulse_app
    from openintel_tpu_torch.cli import render
    from openintel_tpu_torch.config.secrets import Credentials
    from openintel_tpu_torch.config.store import KeychainStore
    from openintel_tpu_torch.sources.x import XPulseSource

    creds = Credentials.load(KeychainStore())
    if not creds.x_bearer:
        return (
            "x pulse is not configured — set OPENINTEL_X_BEARER or run "
            "`openintel setup x`\n",
            1,
        )
    feed = XPulseSource(creds.x_bearer)
    now = dt.datetime.now(dt.timezone.utc)
    try:
        report = asyncio.run(
            pulse_app(
                args.ticker, args.accounts, args.keywords, args.hours,
                args.limit, feed, now,
            )
        )
    except Exception as e:
        return f"error: {e}", 1
    if args.format == "json":
        return render.render_pulse_json(report), 0
    return render.render_pulse_table(report, now), 0


def _wire_bars(offline: bool):
    """Bar source only — the risk calculator is purely market-data driven,
    so it must not pay for (or degrade on) keychain/credential loading and
    social-source construction it never uses."""
    if offline:
        from openintel_tpu_torch.sources.yahoo import FixtureBars

        return FixtureBars()
    from openintel_tpu_torch.sources.yahoo import YahooMarketSource

    return YahooMarketSource()


def run_risk(args) -> tuple[str, int]:
    from openintel_tpu_torch.application.risk import risk_frame, risk_screen
    from openintel_tpu_torch.cli import render
    from openintel_tpu_torch.domain.risk import LONG

    bars = _wire_bars(args.offline)
    now = dt.datetime.now(dt.timezone.utc)
    if len(args.ticker) == 1:  # one frame: pure host math, as the reference's
        try:
            frame = asyncio.run(
                risk_frame(
                    args.ticker[0],
                    args.direction or LONG,
                    args.budget,
                    args.stop_multiple,
                    args.entry,
                    bars,
                    now,
                )
            )
        except Exception as e:
            return f"error: {e}", 1
        if args.format == "json":
            return render.render_risk_json(frame), 0
        return render.render_risk_table(frame), 0

    if args.entry is not None:
        return "error: --entry only applies to a single-ticker frame", 1
    frames = asyncio.run(
        risk_screen(
            args.ticker, args.direction or LONG, args.budget,
            args.stop_multiple, bars, now, device=args.device,
        )
    )
    if args.format == "json":
        payload = [
            {"ticker": t, "error": str(f)}
            if isinstance(f, Exception)
            else f.to_dict()
            for t, f in zip(args.ticker, frames)
        ]
        return json.dumps(payload, indent=2), 0
    lines = []
    for t, f in zip(args.ticker, frames):
        if isinstance(f, Exception):
            lines.append(f"{t}: error — {f}")
        else:
            lines.append(
                f"{f.ticker}: entry {f.entry:.2f}  stop {f.stop:.2f}  "
                f"ATR {f.atr:.2f}  shares {f.shares}  "
                f"max loss ${f.max_loss_usd:.2f}"
            )
    lines += ["", "a calculator, not advice — it never recommends a trade"]
    return "\n".join(lines) + "\n", 0


def run_index(args) -> tuple[str, int]:
    import numpy as np
    import torch

    from openintel_tpu_torch.index.checkpoint import rows_dtype, save_index
    from openintel_tpu_torch.index.schema import (
        DenseIndex,
        dense_store_dtype,
        dense_store_name,
    )
    from openintel_tpu_torch.models.embedding import HashingEmbedder

    texts = read_corpus(args.corpus)
    if not texts:
        return "error: corpus is empty", 1

    if args.dense_store and args.bf16 and args.dense_store != "bf16":
        return "error: --bf16 conflicts with --dense-store f32", 1
    store = args.dense_store or ("bf16" if args.bf16 else "f32")
    dtype = dense_store_dtype(store)
    embedder = None
    if args.encoder:
        from openintel_tpu_torch.models.train import load_embedder

        embedder = load_embedder(args.encoder, device=args.device)
        args.dim = embedder.dim
    if getattr(args, "append", False):
        if args.resume_dir:
            return "error: --append and --resume-dir are exclusive", 1
        from openintel_tpu_torch.index.checkpoint import load_dense, load_postings
        from openintel_tpu_torch.models.updatable import UpdatableHybridRetriever

        prefix = args.out
        if not Path(f"{prefix}.postings.npz").exists():
            return (
                f"error: --append needs an existing index at {prefix} "
                "(build one first without --append)",
                1,
            )
        err = check_index_meta(prefix, args.encoder, embedder)
        if err:
            return err, 1
        postings = load_postings(f"{prefix}.postings.npz")
        dense_idx = load_dense(f"{prefix}.dense.npz")
        stored = dense_store_name(rows_dtype(dense_idx.embeddings))
        if (args.dense_store or args.bf16) and store != stored:
            # silently converting on append would change the recall
            # characteristics of every EXISTING row mid-stream
            return (
                f"error: index at {prefix} stores dense rows as {stored}; "
                f"--append keeps the existing precision (rebuild without "
                f"--append to change it)",
                1,
            )
        n_before = postings.n_docs
        upd = UpdatableHybridRetriever(
            postings, dense_idx, embedder, kernel="xla", device=args.device
        )
        upd.add_documents(texts)
        # compact = a true combined rebuild from the stored arrays
        # (statistics recomputed; no deletes, so ids stay stable)
        new_postings, new_dense, _ = upd.compact()
        docs_path = Path(f"{prefix}.docs.txt")
        new_docs = (
            docs_path.read_text().splitlines() + texts
            if docs_path.exists()
            else None
        )
        save_index(
            prefix, new_postings, new_dense, new_docs, encoder=args.encoder
        )
        return (
            f"appended {len(texts)} docs (ids {n_before}.."
            f"{new_postings.n_docs - 1}) -> {prefix} now "
            f"{new_postings.n_docs} docs\n",
            0,
        )
    embedder = embedder or HashingEmbedder(dim=args.dim)
    if args.resume_dir:
        from openintel_tpu_torch.index.pipeline import build_index_checkpointed

        postings, dense_idx = build_index_checkpointed(
            texts,
            args.resume_dir,
            chunk_docs=args.chunk_docs,
            embedder=embedder,
            log=lambda m: print(m, file=sys.stderr),
        )
        if dtype != np.float32:  # bf16 rounds to nearest even
            rows = np.asarray(dense_idx.embeddings, np.float32)
            dense_idx.embeddings = torch.from_numpy(rows).to(dtype)
        save_index(args.out, postings, dense_idx, texts, encoder=args.encoder)
        return (
            f"indexed {len(texts)} docs (checkpointed in {args.resume_dir}) -> "
            f"{args.out}.postings.npz + {args.out}.dense.npz\n",
            0,
        )
    # the arrays HybridRetriever.build makes; the index is written from
    # the host, so nothing is staged on a device
    from openintel_tpu_torch.index.build import build_postings_index

    postings = build_postings_index(texts)
    dense_idx = DenseIndex.from_embeddings(embedder(texts), dtype=dtype)
    save_index(args.out, postings, dense_idx, texts, encoder=args.encoder)
    return (
        f"indexed {len(texts)} docs -> {args.out}.postings.npz + "
        f"{args.out}.dense.npz ({args.dim}d, dense store {store})\n",
        0,
    )


def check_index_meta(
    prefix: str, encoder: Optional[str], embedder=None
) -> Optional[str]:
    """Returns an error message when the index needs --encoder and none (or
    the wrong kind, or a different-dimension checkpoint) was given; None when
    consistent or unknown (old index).

    ``embedder``: the loaded query embedder, when available — its ``dim`` is
    checked against the index meta so a *different* trained checkpoint (other
    run, other width) can't silently produce garbage dense scores."""
    p = Path(f"{prefix}.meta.json")
    if not p.exists():
        return None
    meta = json.loads(p.read_text())
    if meta.get("embedder") == "neural" and not encoder:
        return (
            "error: this index was embedded with a trained encoder — pass "
            "--encoder CKPT_DIR (dense scores are meaningless otherwise)"
        )
    if meta.get("embedder") == "hashing" and encoder:
        return (
            "error: this index was embedded with the hashing embedder — "
            "drop --encoder or rebuild the index with it"
        )
    want_dim = meta.get("dim")
    got_dim = getattr(embedder, "dim", None)
    if want_dim is not None and got_dim is not None and got_dim != want_dim:
        return (
            f"error: this index was embedded at {want_dim}d but the encoder "
            f"checkpoint embeds at {got_dim}d — wrong checkpoint for this index"
        )
    return None


def kernel_from_flag(flag: Optional[str]) -> Optional[str]:
    """CLI --kernel value -> retriever kernel name (None = library auto)."""
    return None if flag in (None, "auto") else flag


def parse_id_list(
    spec: Optional[str], n_docs: Optional[int] = None
) -> Optional[list[int]]:
    """'3,10-20,512' -> [3, 10, ..., 20, 512] (ranges inclusive);
    None -> None (flag absent). Malformed items — including a PRESENT but
    empty spec, which must never silently mean "no filter" — raise
    ValueError with the item. ``n_docs`` bounds range endpoints BEFORE
    materialization (a typo'd '0-9999999999' must error cleanly, not
    build a ten-billion-element list)."""
    if spec is None:
        return None
    out: list[int] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        # a range has a '-' AFTER the first char (so '-1' parses as an
        # int and hits make_filter_mask's out-of-range error, not here)
        sep = item.find("-", 1)
        try:
            if sep > 0:
                lo, hi = int(item[:sep]), int(item[sep + 1 :])
                if hi < lo:
                    raise ValueError
            else:
                lo = hi = int(item)
        except ValueError:
            raise ValueError(f"bad doc-id item {item!r} (want N or A-B)")
        if n_docs is not None and (lo < 0 or hi >= n_docs):
            raise ValueError(
                f"doc-id item {item!r} out of range [0, {n_docs})"
            )
        out.extend(range(lo, hi + 1))
    if not out:
        raise ValueError(
            f"empty doc-id list {spec!r} — a filter flag that selects "
            "nothing is almost certainly a scripting bug"
        )
    return out


def run_search(args) -> tuple[str, int]:
    from openintel_tpu_torch.index.checkpoint import load_dense, load_postings
    from openintel_tpu_torch.models.retrievers import (
        BM25Retriever,
        DenseRetriever,
        HybridRetriever,
    )

    device = getattr(args, "device", "cuda")
    embedder = None
    if args.encoder:
        from openintel_tpu_torch.models.train import load_embedder

        embedder = load_embedder(args.encoder, device=device)
    # BM25-only search never touches the dense arm: skip the encoder
    # requirement and the (potentially multi-GB) dense checkpoint load.
    # The --mesh path still needs both (the sharded retriever holds the
    # pair).
    bm25_only = args.mode == "bm25" and not getattr(args, "mesh", None)
    if not bm25_only:
        err = check_index_meta(args.index, args.encoder, embedder)
        if err:
            return err, 1
    postings = load_postings(f"{args.index}.postings.npz")
    dense = load_dense(f"{args.index}.dense.npz") if not bm25_only else None
    docs_path = Path(f"{args.index}.docs.txt")
    docs = docs_path.read_text().splitlines() if docs_path.exists() else None

    queries = args.query
    kernel = kernel_from_flag(getattr(args, "kernel", "auto"))
    from openintel_tpu_torch.ops.fusion import BLEND_ALPHA

    fusion = getattr(args, "fusion", "zblend")
    blend_alpha = getattr(args, "blend_alpha", None)
    if blend_alpha is None:
        blend_alpha = BLEND_ALPHA
    elif fusion != "zblend":
        return "error: --blend-alpha only applies to --fusion zblend", 1
    elif not 0.0 <= blend_alpha <= 1.0:
        # outside [0,1] one arm gets a NEGATIVE weight — higher cosine
        # similarity would silently push documents DOWN the ranking
        return (
            f"error: --blend-alpha must be in [0, 1] (got {blend_alpha})",
            1,
        )
    filter_mask = None
    inc_spec = getattr(args, "include_ids", None)
    exc_spec = getattr(args, "exclude_ids", None)
    # `is not None`, NOT truthiness: --include-ids "" (an empty shell
    # variable) must error, never silently search the whole corpus
    if inc_spec is not None or exc_spec is not None:
        from openintel_tpu_torch.models.retrievers import make_filter_mask

        try:
            filter_mask = make_filter_mask(
                postings.n_docs,
                include_ids=parse_id_list(inc_spec, postings.n_docs),
                exclude_ids=parse_id_list(exc_spec, postings.n_docs),
            )
        except (TypeError, ValueError) as e:
            return f"error: {e}", 1
    if getattr(args, "mesh", None):
        from openintel_tpu_torch.parallel.retriever import (
            ShardedHybridRetriever,
            parse_mesh_spec,
        )

        try:
            data, corpus = parse_mesh_spec(args.mesh)
            sharded = ShardedHybridRetriever(
                postings, dense, embedder, data=data, corpus=corpus,
                kernel=sharded_kernel_name(kernel),
                fusion=fusion, blend_alpha=blend_alpha, device=device,
            )
        except ValueError as e:
            return f"error: --mesh {args.mesh}: {e}", 1
        res = sharded.search(
            queries, k=args.k, candidates_per_arm=2 * args.k, mode=args.mode,
            filter_mask=filter_mask,
        )
    elif args.mode == "bm25":
        res = BM25Retriever(postings, device=device).search(
            queries, k=args.k, filter_mask=filter_mask
        )
    elif args.mode == "dense":
        res = DenseRetriever(dense, embedder, kernel=kernel, device=device).search(
            queries, k=args.k, filter_mask=filter_mask
        )
    else:
        res = HybridRetriever(
            postings, dense, embedder, kernel=kernel,
            fusion=fusion, blend_alpha=blend_alpha, device=device,
        ).search(
            queries, k=args.k, candidates_per_arm=2 * args.k,
            filter_mask=filter_mask,
        )

    if args.rerank:
        if docs is None:
            return "error: --rerank needs the index's .docs.txt sidecar", 1
        from openintel_tpu_torch.models.reranker import (
            load_reranker,
            rerank_search_result,
        )

        res = rerank_search_result(
            load_reranker(args.rerank, device=device), queries, res, docs
        )

    if args.format == "json":
        payload = [
            {
                "query": q,
                "hits": [
                    {
                        "doc_id": int(d),
                        "score": float(s),
                        **(
                            {"text": docs[int(d)]}
                            if docs and 0 <= d < len(docs)  # stale sidecar guard
                            else {}
                        ),
                    }
                    for d, s in zip(res.ids[i], res.scores[i])
                    if d >= 0
                ],
            }
            for i, q in enumerate(queries)
        ]
        return json.dumps(payload, indent=2), 0
    lines = []
    for i, q in enumerate(queries):
        lines.append(f"query: {q}  [{args.mode}]")
        for rank, (d, s) in enumerate(zip(res.ids[i], res.scores[i]), 1):
            if d < 0:
                continue
            snippet = (
                f"  {docs[int(d)][:100]}" if docs and 0 <= d < len(docs) else ""
            )
            lines.append(f"  {rank:2d}. doc {int(d)}  score {float(s):.4f}{snippet}")
        lines.append("")
    return "\n".join(lines), 0


def run_mcp(args) -> int:
    from openintel_tpu_torch.mcp.server import serve

    try:
        serve(
            offline=args.offline,
            index=args.index,
            encoder=args.encoder,
            rerank=args.rerank,
            mesh=args.mesh,
            kernel=kernel_from_flag(args.kernel),
            updatable=args.updatable,
            device=args.device,
        )
    except (RuntimeError, ValueError) as e:
        # composition errors: index/encoder mismatch (RuntimeError),
        # --mesh device-count / checkpoint-pair mismatch (ValueError)
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


def run_train(args) -> tuple[str, int]:
    from openintel_tpu_torch.models.encoder import EncoderConfig
    from openintel_tpu_torch.models.train import train_encoder

    texts = read_corpus(args.corpus)
    if not texts:
        return "error: corpus is empty", 1
    logs: list[str] = []
    synonym_map = None
    if args.synonyms:
        synonym_map = {}
        for ln in Path(args.synonyms).read_text().splitlines():
            if not ln.strip():
                continue
            parts = ln.split("\t")
            if len(parts) != 2 or not parts[0].strip() or not parts[1].strip():
                return (
                    f"error: --synonyms line {ln!r} is not "
                    "token<TAB>synonym", 1,
                )
            synonym_map[parts[0].strip()] = parts[1].strip()
        logs.append(f"synonyms: {len(synonym_map)} pairs, flip_p={args.flip_p}")
    cfg = EncoderConfig(dim=args.dim, depth=args.depth, heads=args.heads)
    mesh = None
    if args.mesh:
        from openintel_tpu_torch.parallel.mesh import default_devices, make_mesh
        from openintel_tpu_torch.parallel.retriever import parse_mesh_spec

        try:
            data, model = parse_mesh_spec(args.mesh)
            # a mesh smaller than the devices there are is fine: take the
            # first data*model of them (same rule as search --mesh)
            devices = default_devices(args.device, data * model)[: data * model]
            mesh = make_mesh(data=data, corpus=model, devices=devices)
        except ValueError as e:
            return f"error: --mesh {args.mesh}: {e}", 1
        logs.append(f"mesh: data={data} x model={model}")
    try:
        res = train_encoder(
            texts,
            cfg,
            steps=args.steps,
            batch_size=args.batch_size,
            lr=args.lr,
            seed=args.seed,
            ckpt_dir=args.out,
            log=logs.append,
            mesh=mesh,
            synonym_map=synonym_map,
            flip_p=args.flip_p,
            device=args.device,
        )
    except ValueError as e:
        return f"error: {e}", 1
    logs.append(
        f"trained to step {res.step} on {len(texts)} docs; "
        f"final loss {res.losses[-1]:.4f}" if res.losses else
        f"checkpoint already at step {res.step}; nothing to do"
    )
    logs.append(f"checkpoint: {args.out}/encoder.npz (resumable)")
    if args.analyzer:
        from openintel_tpu_torch.models.neural_analyzer import (
            save_analyzer,
            train_neural_analyzer,
        )

        an, al = train_neural_analyzer(
            texts, cfg, params=res.params, steps=max(20, args.steps),
            seed=args.seed, device=args.device,
        )
        save_analyzer(an, args.out)
        logs.append(
            f"analyzer head distilled ({len(al)} steps, final loss "
            f"{al[-1]:.4f}) -> {args.out}/analyzer.npz"
        )
    if args.reranker:
        from openintel_tpu_torch.models.reranker import save_reranker, train_reranker

        rr, rl = train_reranker(
            texts, cfg, steps=max(10, args.steps // 2), lr=args.lr,
            seed=args.seed,
            synonym_map=synonym_map,
            flip_p=args.flip_p,
            # warm-start the cross-encoder trunk from the just-trained
            # encoder (bi-encoder -> cross-encoder hand-off)
            init_trunk=res.params,
            device=args.device,
        )
        save_reranker(rr, args.out)
        logs.append(
            f"reranker trained ({len(rl)} steps, final loss {rl[-1]:.4f}) -> "
            f"{args.out}/reranker.npz"
        )
    return "\n".join(logs) + "\n", 0


def run_evaluate(args) -> tuple[str, int]:
    from openintel_tpu_torch.models.eval import (
        evaluate_corpus,
        parse_qrels,
        synthetic_qrels,
    )

    texts = read_corpus(args.corpus)
    if not texts:
        return "error: corpus is empty", 1
    if args.queries:
        try:
            qrels = parse_qrels(Path(args.queries).read_text())
        except ValueError as e:
            return f"error: {e}", 1
        bad = {d for _, rel in qrels for d in rel if not 0 <= d < len(texts)}
        if bad:
            return (
                f"error: qrels reference doc ids outside the corpus: "
                f"{sorted(bad)[:5]}...", 1,
            )
    else:
        qrels = synthetic_qrels(texts, args.n_synthetic)
    embedder = None
    if args.encoder:
        from openintel_tpu_torch.models.train import load_embedder

        embedder = load_embedder(args.encoder, device=args.device)
        args.dim = embedder.dim
    modes = (
        ("bm25", "dense", "hybrid") if args.mode == "all" else (args.mode,)
    )
    kernel = kernel_from_flag(args.kernel)
    results = evaluate_corpus(
        texts, qrels, k=args.k, modes=modes, embedder=embedder, dim=args.dim,
        kernel=kernel, device=args.device,
    )
    if args.rerank:
        from openintel_tpu_torch.models.eval import evaluate_retriever
        from openintel_tpu_torch.models.reranker import (
            RerankedRetriever,
            load_reranker,
        )
        from openintel_tpu_torch.models.retrievers import HybridRetriever

        first = HybridRetriever.build(
            texts, dim=args.dim, embedder=embedder, kernel=kernel,
            device=args.device,
        )
        two_stage = RerankedRetriever(
            load_reranker(args.rerank, device=args.device), first, texts
        )
        r = evaluate_retriever(two_stage, qrels, k=args.k, mode="hybrid")
        results = list(results) + [
            type(r)(
                mode="rerank", k=r.k, n_queries=r.n_queries,
                recall_at_k=r.recall_at_k, mrr_at_k=r.mrr_at_k,
                hit_rate=r.hit_rate,
            )
        ]
    if args.format == "json":
        return json.dumps([r.to_dict() for r in results], indent=2), 0
    lines = [
        f"{len(texts)} docs · {len(qrels)} queries · k={args.k}"
        + ("" if args.queries else " (self-labeled synthetic)")
    ]
    for r in results:
        lines.append(
            f"  {r.mode:7s} recall@{r.k} {r.recall_at_k:.3f} · "
            f"MRR {r.mrr_at_k:.3f} · hit rate {r.hit_rate:.3f}"
        )
    return "\n".join(lines) + "\n", 0


def run_doctor(args) -> tuple[str, int]:
    """Environment diagnostics: what will actually run, and where. Builds
    nothing: it reads which libraries exist for these sources."""
    import torch

    import openintel_tpu_torch
    from openintel_tpu_torch import native
    from openintel_tpu_torch.ops import _kernels

    lines = [f"openintel-tpu-torch {openintel_tpu_torch.__version__}"]
    ok = True
    on_cpu = args.device == "cpu"

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    torch_line = f"torch {torch.__version__} (CUDA {torch.version.cuda})"
    if n_cards:
        names = [torch.cuda.get_device_name(i) for i in range(n_cards)]
        lines.append(
            f"{torch_line} — {n_cards} card(s): " + ", ".join(names[:4])
            + (" …" if n_cards > 4 else "")
        )
    elif on_cpu:
        lines.append(f"{torch_line} — no card; --device cpu runs on the host")
    else:
        lines.append(
            f"{torch_line} — NO card: CUDA is unavailable, so every device "
            "command fails (pass --device cpu to run on the host)"
        )
        ok = False

    so = native.library_path()
    if native._load() is not None:
        lines.append(
            f"native tier: C++ tokenizer/postings/planner active ({so.name})"
        )
    elif so.exists() or any(native.BUILD_DIR.glob("libopenintel_native_*.so")):
        # a library is on disk but not for these sources (or _load refused
        # it): the Python fallbacks serve identical results, slower
        lines.append(
            "native tier: STALE — no library matches the .cpp sources "
            "(Python fallbacks active; rebuild with `python -c \"from "
            "openintel_tpu_torch import native; native.build()\"`)"
        )
    else:
        lines.append(
            "native tier: NOT built — Python fallbacks active (run `python -c "
            "\"from openintel_tpu_torch import native; native.build()\"`)"
        )

    try:
        nvcc = _kernels.find_nvcc()
    except _kernels.KernelBuildError:
        nvcc = None
    kernels = _kernels.library_path()
    if kernels.exists():
        lines.append(f"CUDA kernels: built and current ({kernels.name})")
    else:
        lines.append(
            "CUDA kernels: NOT built for these sources (they build at first "
            "use on the card)"
        )
        if nvcc is None and not on_cpu:
            ok = False
    lines.append(f"nvcc: {nvcc or 'not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)'}")

    kernel = (
        "xla (--device cpu: the kernels' plain versions on the host)"
        if on_cpu
        else "int8 candidates (kernel A) + exact rescore at >= 100k docs; the "
        "fused exact top-k (kernel B) below"
    )
    lines.append(f"default dense kernel: {kernel}")

    if args.index:
        from openintel_tpu_torch.index.checkpoint import (
            load_dense,
            load_postings,
            rows_dtype,
        )
        from openintel_tpu_torch.index.schema import dense_store_name

        try:
            postings = load_postings(f"{args.index}.postings.npz")
            dense = load_dense(f"{args.index}.dense.npz")
            emb = "?"
            meta_store = None
            meta_p = Path(f"{args.index}.meta.json")
            if meta_p.exists():
                meta = json.loads(meta_p.read_text())
                emb = meta.get("embedder", "?")
                meta_store = meta.get("dense_store")
            actual_store = dense_store_name(rows_dtype(dense.embeddings))
            lines.append(
                f"index '{args.index}': {postings.n_docs} docs, "
                f"{postings.nnz:,} postings, vocab {postings.vocab.size}, "
                f"dense {dense.dim}d "
                f"(store {actual_store}, embedder {emb}) — OK"
            )
            if meta_store is not None and meta_store != actual_store:
                lines.append(
                    f"  MISMATCH: meta declares dense store {meta_store} "
                    f"but the matrix is {actual_store}"
                )
                ok = False
            if postings.n_docs != dense.n_docs:
                lines.append(
                    f"  MISMATCH: postings {postings.n_docs} docs vs dense "
                    f"{dense.n_docs}"
                )
                ok = False
        except Exception as e:
            lines.append(f"index '{args.index}': INVALID — {e}")
            ok = False

    lines.append("status: ok" if ok else "status: problems found")
    return "\n".join(lines) + "\n", 0 if ok else 1


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _dispatch(args)
    except FileNotFoundError as e:
        # missing corpus/index paths: friendly error, not traceback
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
        return 1


def _dispatch(args) -> int:
    if getattr(args, "coordinator", None):
        # multi-process: join the process group BEFORE any device use
        from openintel_tpu_torch.parallel.distributed import initialize_from_args

        try:
            initialize_from_args(args)
        except (ValueError, RuntimeError) as e:
            print(f"error: --coordinator: {e}", file=sys.stderr)
            return 1
    if args.command == "mcp":
        return run_mcp(args)
    if args.command == "setup":
        from openintel_tpu_torch.cli.setup import run_setup

        out, code = run_setup(args.source, forget=args.forget, verify=args.verify)
    else:
        run = {
            "analyze": run_analyze, "scan": run_scan, "compare": run_compare,
            "pulse": run_pulse, "risk": run_risk, "index": run_index,
            "search": run_search, "train": run_train, "evaluate": run_evaluate,
            "doctor": run_doctor,
        }[args.command]
        out, code = run(args)
    print(out, end="" if out.endswith("\n") else "\n")
    return code


if __name__ == "__main__":
    sys.exit(main())
