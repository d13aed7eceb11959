"""Where the time of kernels A, C2, C1, D, E2, E1 and S goes on the TMA +
wgmma stream, and of kernel B (v2) on its cp.async ring.

Each kernel of ``csrc/tma_stream.cuh`` (A, ``csrc/i8_top2g_tma.cu``; C2
and C1, ``csrc/turbo_i8_tma.cu``; D on bf16 rows,
``csrc/turbo_bf16_tma.cu``; E2 and E1, ``csrc/turbo_i4_tma.cu``; S,
``csrc/dot_only_tma.cu``) is built several ways and timed at the main
path's shapes:

- full: as the port ships it;
- no-fold: the fold callbacks compiled out (``-DOI_STREAM_ABLATE=1``): the
  dots are computed and dropped, no key is formed or written;
- stream: the wgmma products compiled out too (``-DOI_STREAM_ABLATE=2``):
  the TMA loads, the barriers and the ring alone (with E's unpack);
- no-unpack, E only: E's unpack compiled out (``-DOI_STREAM_ABLATE=3``),
  the products and the fold kept: wgmma reads the unpacked ring's stale
  bytes, so the time is all this variant gives;
- ring, E only: the unpack, the products and the fold compiled out
  (``-DOI_STREAM_ABLATE=4``): E's TMA loads and its two rings' barriers.

A, C2, C1, E2 and E1 also run with the doc loads compiled out
(``-DOI_STREAM_ABLATE=5``, no-load: the producer arrives on each stage
without loading, so the consumers alone set the pace; 6, no-load no-fold:
the fold dropped too; 7, fold alone: the products dropped instead), and
with the products alone compiled out (8, no-product: the stream and the
fold). After each kernel's rounds the card's SM clock is read
(``nvidia-smi``), so that times can be turned into clocks.

Kernels C2 and C1 also run the ways of hiding their fold that were built
as measurement variants: two-in-flight (``-DOI_C_FOLD=1``: three
accumulator sets, two wgmma groups left running at each wait; with its
own no-fold), pair-fold (``-DOI_C_FOLD=2``: two sub-blocks folded at a
time by Hopper's three-input max), split-pipes (``-DOI_C_FOLD=3``: C2's
slot 2 on the float pipe, exact up to D=505) and q-smem
(``-DOI_C_QSMEM=1``: wgmma reads the queries from shared memory, not
registers; with its no-fold, no-load and no-load no-fold). At B=256 also
no-cluster (``-DOI_STREAM_NO_CLUSTER=1``: each block loads whole doc
tiles itself, no multicast, no paired release of stages; with its own
no-fold and stream) and, for C2, which is served unpaired, paired
(``-DOI_C_PAIRED=1``: in 2-block clusters, as C1). C2 also runs with 1
and 4 parts per super (as built: up to 2).

Kernel B (``csrc/fused_topk_v2.cu``) takes the same flags: no-fold drops
its selection, stream its products too. On its ``cp.async`` ring (``B
f32``, ``B bf16``) that leaves the staging ring of query and doc slices;
on its TMA + wgmma stream route (``B bf16 stream``, ``route="stream"``)
the stream alone, with four more variants: tests-only
(``-DOI_B_SELECT=1``) keeps the selection's tests and counts but appends
and compacts nothing, no-shared (``-DOI_B_SELECT=2``) drops the threshold
the blocks share, quad-compact (``-DOI_B_COMPACT=1``) compacts all eight
rows of a warp at once, a quad of lanes each, and unrolled-sort
(``-DOI_B_COMPACT=2``) unrolls the one-row-at-a-time sort. It is timed on
the first 98,304 docs (the largest corpus that selects it), k = 32,
B=256 only, and its merge kernel runs in every variant.

Kernel S has no fold: its callback only adds each run's sums into the
output (``atomicAdd``), so its no-fold build drops those adds and nothing
else (the output stays zero); S runs the stream variants, the consumers
alone with and without the adds, and at B=256 the no-cluster ones, and
also unpaired (``paired=False``, a launch option, as built). Its full and
no-cluster builds are held to the twin first.

Kernel A's time includes its second stage (the group fold), which the
variants keep. E2 is also timed with one part per super (as built it
splits supers into up to two, met by a merge kernel). The variants of a
(kernel, batch) run in turns, round after
round; a variant that takes as long as the full kernel shows that what it
dropped is not what bounds it. The variants of C that still compute its
cells (as built, no-cluster, two-in-flight, pair-fold, split-pipes,
q-smem, paired) are first held to the twin, bit for bit, and each row
says whether they agreed. Batches of 128 queries (one query tile: each
doc tile read once per block) and 256 (two tiles, paired in 2-block
clusters but for C2). The operands are random, made on the card from a
seed; the outputs of the variants that drop work are not results.

    python -m openintel_tpu_torch.tools.stream_ablation [N_DOCS] [--reps R]
        [--kernels 'B bf16,B bf16 stream'] [--batches 256] [--variants full,no-fold]

Runs on the card only (the variants are CUDA builds).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys

import torch

from openintel_tpu_torch.ops import _kernels
from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.tools import common

VARIANTS = {
    "full": (),
    "no-fold": ("-DOI_STREAM_ABLATE=1",),
    "stream": ("-DOI_STREAM_ABLATE=2",),
    "no-unpack": ("-DOI_STREAM_ABLATE=3",),
    "ring": ("-DOI_STREAM_ABLATE=4",),
    "tests-only": ("-DOI_B_SELECT=1",),
    "no-shared": ("-DOI_B_SELECT=2",),
    "quad-compact": ("-DOI_B_COMPACT=1",),
    "unrolled-sort": ("-DOI_B_COMPACT=2",),
    "no-cluster": ("-DOI_STREAM_NO_CLUSTER=1",),
    "no-cluster no-fold": ("-DOI_STREAM_NO_CLUSTER=1", "-DOI_STREAM_ABLATE=1"),
    "no-cluster stream": ("-DOI_STREAM_NO_CLUSTER=1", "-DOI_STREAM_ABLATE=2"),
    "two-in-flight": ("-DOI_C_FOLD=1",),
    "two-in-flight no-fold": ("-DOI_C_FOLD=1", "-DOI_STREAM_ABLATE=1"),
    "pair-fold": ("-DOI_C_FOLD=2",),
    "split-pipes": ("-DOI_C_FOLD=3",),
    "paired": ("-DOI_C_PAIRED=1",),
    "no-load": ("-DOI_STREAM_ABLATE=5",),
    "no-load no-fold": ("-DOI_STREAM_ABLATE=6",),
    "fold alone": ("-DOI_STREAM_ABLATE=7",),
    "no-product": ("-DOI_STREAM_ABLATE=8",),
    "q-smem": ("-DOI_C_QSMEM=1",),
    "q-smem no-fold": ("-DOI_C_QSMEM=1", "-DOI_STREAM_ABLATE=1"),
    "q-smem no-load": ("-DOI_C_QSMEM=1", "-DOI_STREAM_ABLATE=5"),
    "q-smem no-load no-fold": ("-DOI_C_QSMEM=1", "-DOI_STREAM_ABLATE=6"),
}
STREAM = ("full", "no-fold", "stream")  # the variants of A, B and D
# the consumers alone: the loads compiled out, with and without the fold,
# and the fold alone; and the stream with the fold but no products
NO_LOAD = ("no-load", "no-load no-fold", "fold alone", "no-product")
# kernels C: also the ways of hiding the fold (the cluster only at B=256)
# and the queries read from shared memory
C_FOLD = (
    *STREAM, *NO_LOAD, "two-in-flight", "two-in-flight no-fold", "pair-fold", "split-pipes",
    "q-smem", "q-smem no-fold", "q-smem no-load", "q-smem no-load no-fold",
)
C_CLUSTER = ("no-cluster", "no-cluster no-fold", "no-cluster stream")
E_STREAM = (*STREAM, "no-unpack", "ring", *NO_LOAD)  # kernels E: also the unpack
# variants that still compute kernels C's cells: each is held to the twin
C_EXACT = ("full", "no-cluster", "two-in-flight", "pair-fold", "split-pipes", "q-smem", "paired")
# kernel B's stream route (bf16 rows): also its selection's tests alone,
# without the threshold the blocks share, and the other two compactions
B_STREAM = (*STREAM, "tests-only", "no-shared", "quad-compact", "unrolled-sort")
# kernel S: the stream variants and the consumers alone, with and without
# the run-end adds (its no-fold drops only those)
S_STREAM = (*STREAM, "no-load", "no-load no-fold")
S_EXACT = ("full", "no-cluster")  # S's variants that still compute the sums
B_DOCS = 98_304  # kernel B's corpus: the largest that selects it
CALLS = 10  # launches per sample


def operands(n_docs: int, batch: int, device: torch.device):
    """Random unit rows on the card: (int8 corpus, int8 queries, bf16
    corpus, bf16 queries, packed int4 corpus), the corpora padded to the
    16,384-doc unit."""
    g = torch.Generator(device=device).manual_seed(0)
    rows = torch.randn((n_docs, common.DIM), device=device, generator=g)
    rows /= rows.norm(dim=1, keepdim=True)
    q = torch.randn((batch, common.DIM), device=device, generator=g)
    q /= q.norm(dim=1, keepdim=True)
    e8 = T.pad_corpus_rows(T.quantize_int8(rows))
    eb = T.pad_corpus_rows(rows.bfloat16())
    e4 = T.pack_corpus_i4(T.quantize_int4(rows))
    return e8, T.quantize_int8(q), eb, q.bfloat16(), e4, rows[:B_DOCS], q


def plan(batch: int) -> dict[str, tuple[str, ...]]:
    """The kernels timed at a batch, each with its variants (kernel B at
    256 only)."""
    c = C_FOLD + (C_CLUSTER if batch == 256 else ())
    kernels = {
        "A": (*STREAM, *NO_LOAD), "C2": c + (("paired",) if batch == 256 else ()), "C1": c,
        "C2 1 part": ("full",),
        "C2 4 parts": ("full",),
        "D": STREAM, "E2": E_STREAM, "E1": E_STREAM, "E2 1 part": ("full",),
        "S": S_STREAM + (C_CLUSTER if batch == 256 else ()), "S unpaired": ("full",),
    }
    if batch == 256:
        kernels.update({"B f32": STREAM, "B bf16": STREAM, "B bf16 stream": B_STREAM})
    return kernels


def ablate(
    n_docs: int, batches=(128, 256), *, reps: int, only=None, variants=None
) -> list[dict]:
    """Rows (kernel, batch, variant, ms median, ms best) per call, the
    variants timed in turns: ``reps`` rounds of CALLS launches each.
    ``only``: the names of the kernels to time, ``variants`` the variants
    (default all of each kernel's)."""
    device = torch.device("cuda")
    e8, q8_all, eb, qb_all, e4, b_rows, qf_all = operands(n_docs, max(batches), device)
    b_bf16 = b_rows.bfloat16()
    group = T.auto_i8_group(n_docs, common.C)
    sub = common.BLOCK_C // 128
    rows = []
    for batch in batches:
        q8, qb = q8_all[:batch].contiguous(), qb_all[:batch].contiguous()
        qf = qf_all[:batch].contiguous()
        calls = {
            "A": lambda: T.i8_top2g_cells(q8, e8, group=group, sub=sub),
            "C2": lambda: T.i8_turbo_cells(q8, e8, slots=2),
            "C1": lambda: T.i8_turbo_cells(q8, e8, slots=1),
            "C2 1 part": lambda: T.i8_turbo_cells(q8, e8, slots=2, max_parts=1),
            "C2 4 parts": lambda: T.i8_turbo_cells(q8, e8, slots=2, max_parts=4),
            "D": lambda: T.fast_cells(qb, eb),
            "E2": lambda: T.i4_cells(q8, e4, slots=2),
            "E1": lambda: T.i4_cells(q8, e4, slots=1),
            "E2 1 part": lambda: T.i4_cells(q8, e4, slots=2, max_parts=1),
            "B f32": lambda: T.fused_topk(b_rows, qf, common.C),
            "B bf16": lambda: T.fused_topk(b_bf16, qb, common.C),
            "B bf16 stream": lambda: T.fused_topk(b_bf16, qb, common.C, route="stream"),
            "S": lambda: T.dot_only_cells(q8, e8),
            "S unpaired": lambda: T.dot_only_cells(q8, e8, paired=False),
        }
        kernels = plan(batch)
        if only is not None:
            kernels = {name: kernels[name] for name in only if name in kernels}
        if variants is not None:
            kernels = {k: tuple(v for v in names if v in variants) for k, names in kernels.items()}
        for names in kernels.values():
            for name in names:
                _kernels.load_library(VARIANTS[name])  # build before timing
        for kernel, names in kernels.items():
            exact = {}
            if kernel.startswith("C"):  # the twin once, then each exact variant
                slots = 1 if kernel == "C1" else 2
                want = T.i8_turbo_cells_plain(q8, e8, slots=slots)
                for name in set(names) & set(C_EXACT):
                    with _kernels.extra_flags(VARIANTS[name]):
                        exact[name] = bool(torch.equal(calls[kernel](), want))
                del want
            if kernel.startswith("S"):  # the lane sums, by the exact variants
                want = T.dot_only_plain(q8, e8)
                for name in set(names) & set(S_EXACT):
                    with _kernels.extra_flags(VARIANTS[name]):
                        exact[name] = bool(torch.equal(calls[kernel](), want))
            samples = {name: [] for name in names}
            for _ in range(reps + 1):  # the first round warms up
                for name in names:
                    with _kernels.extra_flags(VARIANTS[name]):
                        samples[name].append(_time(calls[kernel], device))
            mhz = sm_clock_mhz()
            for name, ms in samples.items():
                ms = ms[1:]
                rows.append({
                    "kernel": kernel, "batch": batch, "variant": name,
                    "ms_median": statistics.median(ms), "ms_best": min(ms),
                    "exact": exact.get(name), "sm_mhz": mhz,
                })
    return rows


def sm_clock_mhz() -> str:
    """The card's SM clock now, as ``nvidia-smi`` reads it (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time(fn, device) -> float:
    """Milliseconds per call over CALLS back-to-back calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_docs", nargs="?", type=int, default=1_250_000)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument(
        "--kernels", default=None,
        help="comma-separated kernels to time (A, C2, C1, 'C2 1 part', 'C2 4 parts', D, "
        "E2, E1, 'E2 1 part', S, 'S unpaired', 'B f32', 'B bf16', 'B bf16 stream'; "
        "default all)",
    )
    parser.add_argument("--batches", default="128,256", help="comma-separated batch sizes")
    parser.add_argument(
        "--variants", default=None, help="comma-separated variants to run (default all)"
    )
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("stream_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    print(common.device_line(device))
    only = args.kernels.split(",") if args.kernels else None
    batches = tuple(int(x) for x in args.batches.split(","))
    variants = args.variants.split(",") if args.variants else None
    for row in ablate(args.n_docs, batches, reps=args.reps, only=only, variants=variants):
        n = min(args.n_docs, B_DOCS) if row["kernel"].startswith("B ") else args.n_docs
        print(
            f"kernel {row['kernel']} B={row['batch']} {row['variant']:<13} "
            f"{row['ms_median']:.4f} ms median {row['ms_best']:.4f} best per call "
            f"(N={n}, D={common.DIM}; {args.reps} rounds of {CALLS} calls; SM clock "
            f"{row['sm_mhz']} MHz after them)"
            + {None: "", True: "; cells equal to the twin", False: "; CELLS DIFFER FROM THE TWIN"}[
                row["exact"]]
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
