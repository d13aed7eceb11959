"""The dense arm's least time on one H100, from the shapes alone.

The arm's work is fixed by what it computes, whatever kernels implement
it: every stored int8 row read once, the queries (int8 for the candidate
pass, float32 for the rescore), the ``c`` candidate rows per query read
again at the stored width (bf16) for the exact rescore, and the top-k
(value, id) pairs written. Its operations are the int8 products of every
query with every row, 2 * B * N * D. The least time is the larger of
bytes over the published bandwidth and operations over the published
int8 rate; ``bound_by`` says which.

Peaks are NVIDIA's data sheet for the H100 SXM part at its 700 W limit
(dense rates, no sparsity). A card set below 700 W runs slower under
load, so every share is reported with the card's ``power.limit`` beside
it (:func:`power_limit`).
"""

from __future__ import annotations

import shutil
import subprocess
from dataclasses import dataclass

H100_INT8_OPS = 1979e12  # int8 tensor-core operations a second
H100_HBM_BYTES = 3.35e12  # bytes a second
H100_POWER_W = 700.0  # the limit the peaks assume


@dataclass(frozen=True)
class ArmWork:
    bytes: float
    ops: float

    @property
    def seconds(self) -> float:
        return max(self.bytes / H100_HBM_BYTES, self.ops / H100_INT8_OPS)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes / H100_HBM_BYTES >= self.ops / H100_INT8_OPS else "ops"


def dense_arm_work(
    n_docs: int, dim: int, batch: int, candidates: int, k: int, store_bytes: int = 2
) -> ArmWork:
    """Bytes and int8 operations of one dense-arm call over ``batch``
    queries: kernel A's stream of the int8 rows, then the exact rescore of
    ``candidates`` stored rows per query."""
    rows = n_docs * dim  # int8, read once
    queries = batch * dim * (1 + 4)  # int8 for the pass, f32 for the rescore
    rescore = batch * candidates * dim * store_bytes
    out = batch * k * (4 + 4)  # f32 value, int32 id
    return ArmWork(bytes=float(rows + queries + rescore + out), ops=2.0 * batch * n_docs * dim)


def arm_candidates(k: int, candidates: int | None) -> int:
    """The candidate count the arm rescores: the hybrid step passes its
    ``candidates_per_arm``; the dense search takes the arm's own default,
    max(2k, 32)."""
    return candidates if candidates else max(2 * k, 32)


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them, or None
    where it is absent."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True,
        )
    except (subprocess.SubprocessError, OSError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
