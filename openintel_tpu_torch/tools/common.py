"""Shared pieces of the measurement tools: the command line, the device
and the JSON every tool writes, the scripts' corpus and queries, timing per
sub-batch, and recall against the exact oracle.

Timing: each rep runs all NB sub-batches once, after one warm-up rep; a
rep's time over NB is one sample, and a row gives the median and the best
sample. On the card the clock is a pair of CUDA events around the rep
(where the reference timed one jitted ``lax.scan`` with a scalar readback);
on the CPU it is the host clock, and the rows say so.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from openintel_tpu_torch import convert
from openintel_tpu_torch.index.schema import DenseIndex
from openintel_tpu_torch.index.synthetic import synthetic_postings_index
from openintel_tpu_torch.models.retrievers import HybridRetriever
from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.ops.dense import dense_topk_xla

DIM = 384  # the scripts' embedding width
K = 10  # recall@K after rescore
C = 32  # candidates per query (the served default)
BLOCK_C = 8192  # the scripts' block_c
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "tools"  # ignored by git


def parse_args(argv, doc: str, *, nb: int = 32, out: str | None = None) -> argparse.Namespace:
    """``[N_DOCS] [BATCH] [NB] [--device DEVICE]`` with the scripts'
    defaults (1,250,000 docs, sub-batches of 256, ``nb`` of them); with
    ``out``, also ``--out`` (default ``build/tools/OUT.json``)."""
    parser = argparse.ArgumentParser(
        description=doc.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("n_docs", nargs="?", type=int, default=1_250_000)
    parser.add_argument("batch", nargs="?", type=int, default=256)
    parser.add_argument("nb", nargs="?", type=int, default=nb)
    add_device_flags(parser, out)
    return parser.parse_args(argv)


def add_device_flags(parser: argparse.ArgumentParser, name: str | None) -> None:
    """``--device`` (default cuda) and, for a tool that writes ``NAME.json``,
    ``--out`` (default ``build/tools/NAME.json``): the flags a tool adds to
    its script's."""
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; cpu runs the kernels' plain twins)",
    )
    if name is not None:
        parser.add_argument(
            "--out", default=None, help=f"results JSON path (default build/tools/{name}.json)"
        )


def tool_device(name: str) -> torch.device:
    """The device a tool runs on: the card unless the caller asks for the
    CPU. A tool asked for the card that finds none stops; nothing moves to
    the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: the tools measure the card (--device cpu runs the "
            "plain twins at a small size)"
        )
    return device


def stamp(device: torch.device) -> dict:
    """The fields every tool's JSON carries: ``backend`` (cuda or cpu) and
    the card's name and power limit as nvidia-smi reports them (null on
    the CPU)."""
    return {
        "backend": device.type,
        "card": device_line(device) if device.type == "cuda" else None,
    }


def write_json(result: dict, out: str | None, name: str) -> Path:
    """Write ``result`` to ``out``, by default ``build/tools/NAME.json``."""
    path = Path(out) if out else OUT_DIR / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=2))
    return path


def bench_strings(index, rng: np.random.Generator, n: int, vocab_size: int) -> list[str]:
    """``bench.py``'s query strings: 4 term ranks a query, log-uniform over
    50 .. vocab_size - 1, each rank r the text of term id r + 1."""
    ranks = np.exp(
        rng.uniform(np.log(50), np.log(vocab_size - 1), size=(n, 4))
    ).astype(np.int64)
    id_to_term = {tid: tok for tok, tid in index.vocab.token_to_id.items()}
    return [" ".join(id_to_term.get(int(r) + 1, "t1") for r in row) for row in ranks]


def bench_retriever(n_docs: int, vocab_size: int, kernel: str, store, device, *, device_batch: int = 256):
    """``bench.py``'s corpus: the seed-0 synthetic postings and unit rows from
    ``default_rng(1)`` (384 wide) stored as ``store``, behind a
    ``HybridRetriever`` on ``device``. Returns (retriever, index, rng), the
    rng where the rows left it (the queries come next)."""
    index = synthetic_postings_index(n_docs, vocab_size=vocab_size, seed=0)
    index.ensure_impact_order()
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((n_docs, DIM), dtype=np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    retriever = HybridRetriever(
        index, DenseIndex.from_embeddings(emb, dtype=store), kernel=kernel,
        device_batch=device_batch, device=device,
    )
    return retriever, index, rng


def served_defaults(device: torch.device) -> dict:
    """The scripts' sizes and arms: bench scale on the card, a tiny corpus
    on the CPU."""
    card = device.type == "cuda"
    return {
        "n_docs": int(os.environ.get("BENCH_DOCS", 0)) or (1_250_000 if card else 20_000),
        "vocab_size": 30_000 if card else 3_000,
        "kernel": os.environ.get("BENCH_DENSE", "int8" if card else "xla"),
    }


def device_line(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi reports them, or the
    CPU's stand-in (no device time is measured there)."""
    if device.type != "cuda":
        return f"{device.type}: host clock, plain twins (no device time)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def unit_rows(x: np.ndarray) -> np.ndarray:
    """Rows scaled to unit norm, in place (the scripts' normalisation)."""
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    return x


def script_corpus(
    n_docs: int, total_q: int, *, near_docs: bool, dim: int = DIM
) -> tuple[np.ndarray, np.ndarray]:
    """The scripts' float32 corpus and queries from ``default_rng(1)``:
    unit rows, and either independent unit queries (``bench_kernel_decomp``)
    or unit-normalised docs plus 0.6 noise (``near_docs``, the two A/B
    scripts)."""
    rng = np.random.default_rng(1)
    emb = unit_rows(rng.standard_normal((n_docs, dim), dtype=np.float32))
    if near_docs:
        targets = rng.integers(0, n_docs, size=total_q)
        noise = rng.standard_normal((total_q, dim)).astype(np.float32)
        q = emb[targets] + 0.6 * noise
    else:
        q = rng.standard_normal((total_q, dim)).astype(np.float32)
    return emb, unit_rows(q)


def device_operands(
    emb: np.ndarray, q: np.ndarray, nb: int, batch: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rows (N, D) f32, int8 corpus (N_pad, D), int8 queries (NB, BATCH,
    D), f32 queries (NB, BATCH, D)) on ``device``; the int8 corpus is
    quantised from the rows and padded once, as at index load."""
    rows = torch.from_numpy(emb).to(device)
    qf = torch.from_numpy(q).to(device).view(nb, batch, -1)
    return rows, convert.int8_corpus(rows), T.quantize_int8(qf), qf


def exact_ids(rows: torch.Tensor, queries: torch.Tensor) -> np.ndarray:
    """The exact float32 oracle's top-K ids, (B, K), ties to the lower id."""
    return dense_topk_xla(rows, queries, K)[1].cpu().numpy()


def recall_at_k(ids: np.ndarray, ref_ids: np.ndarray) -> float:
    """Mean over the oracle's queries of |top-k ∩ oracle top-k| / k, k the
    oracle's width."""
    k = ref_ids.shape[1]
    got = np.asarray(ids)[: ref_ids.shape[0], :k]
    return float(np.mean([
        len(set(g.tolist()) & set(r.tolist())) / k for g, r in zip(got, ref_ids)
    ]))


def time_per_sub_batch(run, nb: int, reps: int, device: torch.device):
    """(median, best) milliseconds per sub-batch of ``run(i)`` over ``reps``
    reps of i = 0 .. nb - 1, after one warm-up rep."""

    def rep() -> float:
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for i in range(nb):
                run(i)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / nb
        t0 = time.perf_counter()
        for i in range(nb):
            run(i)
        return (time.perf_counter() - t0) * 1e3 / nb

    rep()
    samples = [rep() for _ in range(reps)]
    return statistics.median(samples), min(samples)


def row_line(row: dict) -> str:
    """One row as the scripts print it: ms per sub-batch (median and best),
    microseconds per query and queries per second at the best, and recall
    where measured; a derived row, its difference alone."""
    best = row["ms_best"]
    if row.get("derived"):  # a difference of two rows: no rate of its own
        return (
            f"{row['label']:<30} {row['ms_median']:8.3f} ms/sub-batch median "
            f"{best:8.3f} best  (a difference of two rows)"
        )
    line = (
        f"{row['label']:<30} {row['ms_median']:8.3f} ms/sub-batch median "
        f"{best:8.3f} best  {best * 1e3 / row['batch']:7.3f} us/q  "
        f"({row['batch'] * 1e3 / best:>10,.0f} QPS)"
    )
    if "recall" in row:
        line += f"  recall@{K} {row['recall']:.4f}"
    return line


def clock_note(device: torch.device, reps: int, nb: int) -> str:
    """How the rows were timed."""
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    return (
        f"timing: {clock}, {reps} reps of {nb} sub-batches after a warm-up; "
        "median and best per sub-batch (the reference timed a jitted lax.scan)"
    )
