"""The candidate-pass measurement tools (``openintel_tpu_torch.tools``) on the
CPU at a small size: 40,000 docs x 64, sub-batches of 32, two of them, one
rep. On CPU tensors the kernels' plain twins run and the clock is the
host's, so these tests check what the tools compute and print, not their
times. The reducers of ``topk_reduce_ab`` are held to numpy oracles of the
reference script's reductions."""

import numpy as np
import pytest
import torch

from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.tools import common, grouped_ab, kernel_decomp, topk_reduce_ab

N, DIM, BATCH, NB = 40_000, 64, 32, 2
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def operands():
    emb, q = common.script_corpus(N, NB * BATCH, near_docs=True, dim=DIM)
    rows, corpus, q8s, qfs = common.device_operands(emb, q, NB, BATCH, CPU)
    ref_ids = common.exact_ids(rows, qfs.view(NB * BATCH, DIM)[:48])
    return rows, corpus, q8s, qfs, ref_ids


def _check_rows(rows, labels):
    assert [r["label"] for r in rows] == labels
    for r in rows:
        assert r["batch"] == BATCH
        if r.get("derived"):
            continue
        assert 0 < r["ms_best"] <= r["ms_median"] < float("inf")
        if "recall" in r:
            assert 0.0 <= r["recall"] <= 1.0
        assert common.row_line(r).startswith(r["label"])


def test_kernel_decomp_core(operands):
    _, corpus, q8s, _, _ = operands
    rows = kernel_decomp.decompose(corpus, q8s, N, reps=1)
    _check_rows(rows, [
        "dot-only (MXU+stream floor) [TMA+wgmma stream]",
        "fold-only (pack+2max, no topk) [TMA+wgmma stream]",
        "turbo slots=1 (+select+dec) [TMA+wgmma stream]",
        "turbo slots=2 (+select+dec) [TMA+wgmma stream]",
        "fold = fold-only - dot-only [TMA+wgmma stream]",
    ])
    # the derived row subtracts the dot-only row from the fold-only row
    dot, fold, derived = rows[0], rows[1], rows[4]
    assert derived["derived"] and not any(r.get("derived") for r in rows[:4])
    assert derived["ms_median"] == fold["ms_median"] - dot["ms_median"]
    assert derived["ms_best"] == fold["ms_best"] - dot["ms_best"]
    assert common.row_line(derived).endswith("(a difference of two rows)")


def test_topk_reduce_ab_core(operands):
    rows, corpus, q8s, qfs, ref_ids = operands
    out = topk_reduce_ab.reduce_ab(corpus, rows, q8s, qfs, N, ref_ids, reps=1)
    _check_rows(out, [
        "approx (exact select)", "group4", "group8", "group16", "exact-topk-768",
    ])
    by = {r["label"]: r["recall"] for r in out}
    assert by["approx (exact select)"] == by["exact-topk-768"] >= 0.95


def test_grouped_ab_core(operands):
    rows, corpus, q8s, qfs, ref_ids = operands
    out = grouped_ab.grouped_ab(
        corpus, rows, q8s, qfs, N, ref_ids, groups=[1, 2], reps=1
    )
    _check_rows(out, ["int8 per-super+select", "grouped g=1", "grouped g=2"])
    assert [r["group"] for r in out] == [0, 1, 2]


def _oracle_grouped(packed, n_super, n_docs, c, g):
    """numpy: the reference script's reduce_grouped (max, first argmax over
    g supers per slot and lane, sentinel-0 padding, exact top c, ties to the
    lower column)."""
    b = packed.shape[0]
    ng = -(-n_super // g)
    pk = np.zeros((b, 2, ng * g, 128), np.int64)
    pk[:, :, :n_super] = packed.reshape(b, 2, n_super, 128)
    pk = pk.reshape(b, 2, ng, g, 128)
    best, arg = pk.max(axis=3), pk.argmax(axis=3)
    width = 2 * ng * 128
    keys = best.reshape(b, width)
    col = np.arange(width)
    sup = ((col // 128) % ng) * g + arg.reshape(b, width)
    ids = (sup * 128 + (keys & 127)) * 128 + col % 128
    valid = (ids < n_docs) & (keys > 0)
    masked = np.where(valid, keys, -(2**31))
    sel = np.argsort(-masked, axis=1, kind="stable")[:, :c]
    return np.take_along_axis(np.where(valid, ids, -1), sel, axis=1)


def _oracle_exact(packed, n_super, n_docs, c):
    half = n_super * 128
    sel = np.argsort(-packed.astype(np.int64), axis=1, kind="stable")[:, :c]
    keys = np.take_along_axis(packed.astype(np.int64), sel, axis=1)
    col = sel % half
    ids = ((col // 128) * 128 + (keys & 127)) * 128 + col % 128
    return np.where((ids < n_docs) & (keys > 0), ids, -1)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_reducers_match_numpy_oracles(operands, g):
    """On kernel C2's cells (the twin's) of two corpora: the small-corpus
    case, where padding fills the last super, and a tie-heavy one."""
    _, corpus, q8s, _, _ = operands
    rng = np.random.default_rng(61)
    ties = T.pad_corpus_rows(torch.from_numpy(rng.integers(-1, 2, (N, DIM)).astype(np.int8)))
    tie_q = torch.from_numpy(rng.integers(-1, 2, (BATCH, DIM)).astype(np.int8))
    n_super = corpus.shape[0] // T._TURBO_UNIT
    for crp, q in ((corpus, q8s[0]), (ties, tie_q)):
        packed = T.i8_turbo_cells_plain(q, crp, slots=2)
        got = topk_reduce_ab.reduce_grouped(packed, n_super, N, common.C, g)
        want = _oracle_grouped(packed.numpy(), n_super, N, common.C, g)
        np.testing.assert_array_equal(got.numpy(), want)
        got = topk_reduce_ab.reduce_exact_topk(packed, n_super, N, common.C)
        np.testing.assert_array_equal(got.numpy(), _oracle_exact(packed.numpy(), n_super, N, common.C))
        sel = topk_reduce_ab.reduce_select(packed, n_super, N, common.C)
        assert sel.shape == (BATCH, common.C) and int(sel.max()) < N


@pytest.mark.parametrize("tool", [kernel_decomp, topk_reduce_ab, grouped_ab])
def test_tool_commands_print_their_rows(tool, monkeypatch, capsys):
    """``python -m openintel_tpu_torch.tools.<name> N BATCH NB --device cpu``:
    the device line first, the clock note, then one row per probe."""
    monkeypatch.setenv("AB_REPS", "1")
    monkeypatch.setenv("AB_SAMPLE", "16")
    monkeypatch.setenv("AB_GROUPS", "2")
    assert tool.main([str(N), str(BATCH), str(NB), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cpu: host clock")
    assert any(line.startswith("timing: host clock, 1 reps of 2 sub-batches") for line in lines)
    n_rows = {kernel_decomp: 5, topk_reduce_ab: 5, grouped_ab: 2}[tool]
    assert sum("ms/sub-batch" in line for line in lines) == n_rows


def test_stream_ablation_needs_the_card(monkeypatch, capsys):
    """The ablation builds are CUDA variants: without a card the tool
    refuses and prints no row."""
    from openintel_tpu_torch.tools import stream_ablation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert stream_ablation.main(["40000"]) == 2
    assert capsys.readouterr().out == ""


def test_measurement_builds_are_libraries_of_their_own():
    """A build with extra flags (an ablation variant) is named apart from
    the port's library, and launches reach it only inside the block."""
    from openintel_tpu_torch.ops import _kernels
    from openintel_tpu_torch.tools import stream_ablation

    names = {_kernels.library_path(f) for f in stream_ablation.VARIANTS.values()}
    assert len(names) == len(stream_ablation.VARIANTS) == 25
    assert _kernels.library_path() in names
    flags = stream_ablation.VARIANTS["stream"]
    with _kernels.extra_flags(flags):
        assert _kernels._flags == flags
    assert _kernels._flags == ()


@pytest.mark.parametrize("batch", [128, 256])
def test_stream_ablation_plans_kernels_c_and_their_fold_variants(batch):
    """C2 and C1 run the stream variants and the three ways of hiding the
    fold, the cluster ones at B=256 only (B=128 is one query tile, no
    cluster); every variant has its build flags."""
    from openintel_tpu_torch.tools import stream_ablation as S

    plan = S.plan(batch)
    for kernel in ("C2", "C1"):
        names = plan[kernel]
        assert names[:3] == ("full", "no-fold", "stream")
        assert {"two-in-flight", "two-in-flight no-fold", "pair-fold", "q-smem"} <= set(names)
        assert {"no-load", "no-load no-fold", "fold alone", "no-product"} <= set(names)
        assert ("no-cluster" in names) == (batch == 256)
        assert ("paired" in names) == (batch == 256 and kernel == "C2")
    assert plan["C2 1 part"] == plan["C2 4 parts"] == ("full",)
    assert ("B bf16 stream" in plan) == (batch == 256)
    # kernel S: its no-fold drops only the run-end adds
    assert plan["S"][:5] == ("full", "no-fold", "stream", "no-load", "no-load no-fold")
    assert ("no-cluster" in plan["S"]) == (batch == 256)
    assert plan["S unpaired"] == ("full",)
    for names in plan.values():
        assert set(names) <= set(S.VARIANTS)
    assert S.VARIANTS["two-in-flight"] == ("-DOI_C_FOLD=1",)
    assert S.VARIANTS["pair-fold"] == ("-DOI_C_FOLD=2",)
    assert S.VARIANTS["no-load"] == ("-DOI_STREAM_ABLATE=5",)
    assert S.VARIANTS["no-cluster no-fold"] == ("-DOI_STREAM_NO_CLUSTER=1", "-DOI_STREAM_ABLATE=1")


def test_ptxas_report_reads_the_compiler_log_and_the_sass():
    """The build comparison's parsers on a log and SASS lines in the
    compiler's formats (the build itself needs nvcc)."""
    from openintel_tpu_torch.tools import ptxas_report

    log = """ptxas info    : Compiling entry function '_Z6kernelPi' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPi
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 488 bytes cmem[0]
ptxas info    : Compiling entry function '_Z4fillPi' for 'sm_90a'
ptxas info    : Function properties for _Z4fillPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 10 registers, 372 bytes cmem[0]
"""
    got = ptxas_report.ptxas_entries(log)
    assert got == {
        "_Z6kernelPi": {"stack": 8, "spill_st": 4, "spill_ld": 12, "regs": 168},
        "_Z4fillPi": {"stack": 0, "spill_st": 0, "spill_ld": 0, "regs": 10},
    }
    lines = [
        "        /*0070*/                   IMNMX R5, R4, R5, !PT ;   /* 0x0000000504057248 */",
        "        /*0080*/               @!P0 BRA 0x190 ;              /* 0x000000000000094c */",
        "        /*0090*/                   VIMNMX3 R2, R3, R4, R5, !PT ; /* 0x0000000403027248 */",
    ]
    instrs = [ptxas_report._INSTR.search(line).group(1) for line in lines]
    name = "_ZN44_GLOBAL__N__62b4206e_11_turbo_i8_cu_83787ca615turbo_i8_kernelILi7ELi1ELi1EEEvPKaS2_Piii"
    assert ptxas_report.kernel_name(name) == "_ZN44_ANON_turbo_i815turbo_i8_kernelILi7ELi1ELi1EEEvPKaS2_Piii"
    assert [ptxas_report.opcode(i) for i in instrs] == ["IMNMX", "BRA", "VIMNMX3"]


def test_serving_ab_turns_and_reads_phases_14_and_15():
    """``serving_ab`` alternates the trees (a, b, b, a per round) and reads
    the rates and latencies from the lines phases 14 and 15 print."""
    from openintel_tpu_torch.tools import serving_ab

    assert serving_ab.run_order(2) == [0, 1, 1, 0, 0, 1, 1, 0]
    text = (
        "phase14 pipelined serving at N=1250000, D=384 (int8 arm), 8 waves of 4 x 256 "
        "queries, depth 2: sequential 17605 q/s (0.500/0.431 s), pipelined 19271 q/s "
        "(0.463/0.388 s), ratio 1.095; per wave alone: prepare 39.6 ms, step 14.6 ms\n"
        "phase15 coalesced serving: 8 callers x 64 queries for 5.02 s: 454 calls, "
        "batches_run 160, queries_run 29056, 5784 q/s; caller latency p50 81.6 ms, "
        "p99 230.8 ms, max 296.2 ms; waves: 60 full of 256\n"
    )
    assert serving_ab.parse(text) == {
        "sequential": 17605.0, "pipelined": 19271.0, "prepare_ms": 39.6,
        "coalesced": 5784.0, "p50_ms": 81.6, "p99_ms": 230.8,
    }
    with pytest.raises(ValueError, match="coalesced"):
        serving_ab.parse(text.splitlines()[0])
