"""Shared pieces of the measurement tools: the command line, the scripts'
corpus and queries, timing per sub-batch, and recall against the exact
oracle.

Timing: each rep runs all NB sub-batches once, after one warm-up rep; a
rep's time over NB is one sample, and a row gives the median and the best
sample. On the card the clock is a pair of CUDA events around the rep
(where the reference timed one jitted ``lax.scan`` with a scalar readback);
on the CPU it is the host clock, and the rows say so.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch

from openintel_tpu_torch import convert
from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.ops.dense import dense_topk_xla

DIM = 384  # the scripts' embedding width
K = 10  # recall@K after rescore
C = 32  # candidates per query (the served default)
BLOCK_C = 8192  # the scripts' block_c


def parse_args(argv, doc: str) -> argparse.Namespace:
    """``[N_DOCS] [BATCH] [NB] [--device DEVICE]`` with the scripts'
    defaults (1,250,000 docs, sub-batches of 256, 32 of them)."""
    parser = argparse.ArgumentParser(
        description=doc.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("n_docs", nargs="?", type=int, default=1_250_000)
    parser.add_argument("batch", nargs="?", type=int, default=256)
    parser.add_argument("nb", nargs="?", type=int, default=32)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; cpu runs the kernels' plain twins)",
    )
    return parser.parse_args(argv)


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
