"""The port's measurement tools of the reference's eight JAX scripts
(``openintel_tpu_torch.tools``: profile_planner, coalescer, arrival,
encoder_quality, fusion_ab, sharded_overhead, batch_ab, int4_ab) on the
CPU at a small size. On CPU tensors the kernels' plain twins run and the
clock is the host's, so these tests check what each tool's core computes
and what its command writes, not its times."""

import json

import numpy as np
import pytest
import torch

from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.tools import (
    arrival,
    batch_ab,
    coalescer,
    common,
    encoder_quality,
    fusion_ab,
    int4_ab,
    profile_planner,
    sharded_overhead,
)

CPU = torch.device("cpu")
N_OPS = 16_000  # docs of the A/B tools' operands: one super
TOOLS = [profile_planner, coalescer, arrival, encoder_quality, fusion_ab, sharded_overhead, batch_ab, int4_ab]
# tiny encoder_quality arguments (the reference script's flags)
EQ_ARGS = [
    "--n-docs", "150", "--n-concepts", "20", "--steps", "3", "--rerank-steps", "2",
    "--batch", "8", "--dim", "16", "--depth", "1", "--heads", "2", "--vocab", "256",
    "--queries", "10",
]


@pytest.fixture(scope="module")
def served():
    """The scripts' bench corpus at 3,000 docs on the CPU (xla arm, f32)."""
    retr, index, rng = common.bench_retriever(3_000, 3_000, "xla", np.float32, CPU)
    return retr, common.bench_strings(index, rng, 16 * 64, 3_000)


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_run_on_the_card_unless_asked_for_the_cpu(tool, monkeypatch, capsys):
    """Without a card, a tool's default (--device cuda) stops before any
    work, printing no row and writing no JSON: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([])
    assert capsys.readouterr().out == ""


def test_outputs_default_under_build_tools(tmp_path):
    """The default JSON lands under the ignored ``build/tools/``, never
    under ``docs/``; ``--out`` puts it anywhere."""
    assert common.OUT_DIR.parts[-2:] == ("build", "tools")
    assert (common.OUT_DIR.parents[1] / "openintel_tpu_torch").is_dir()
    path = common.write_json({"a": 1}, str(tmp_path / "x" / "y.json"), "unused")
    assert json.loads(path.read_text()) == {"a": 1}


def test_served_defaults_follow_the_scripts(monkeypatch):
    """Bench scale and the int8 arm (kernel A) on the card, a tiny xla
    corpus on the CPU; BENCH_DOCS and BENCH_DENSE override both."""
    for var in ("BENCH_DOCS", "BENCH_DENSE"):
        monkeypatch.delenv(var, raising=False)
    assert common.served_defaults(torch.device("cuda")) == {
        "n_docs": 1_250_000, "vocab_size": 30_000, "kernel": "int8",
    }
    assert common.served_defaults(CPU) == {"n_docs": 20_000, "vocab_size": 3_000, "kernel": "xla"}
    monkeypatch.setenv("BENCH_DOCS", "5000")
    monkeypatch.setenv("BENCH_DENSE", "int4")
    assert common.served_defaults(CPU) == {"n_docs": 5_000, "vocab_size": 3_000, "kernel": "int4"}


def test_profile_planner_core_and_command(monkeypatch, tmp_path, capsys):
    """The profile library is built beside (not over) the production
    library; the five phases account for the instrumented time; the
    command prints the breakdown and writes its JSON."""
    from openintel_tpu_torch import native
    from openintel_tpu_torch.index.synthetic import synthetic_postings_index

    assert profile_planner.profile_library_path() != native.library_path()
    assert profile_planner.profile_library_path().parent == native.BUILD_DIR
    lib = profile_planner.build_profile_lib()
    index = synthetic_postings_index(20_000, vocab_size=3_000, seed=0)
    q = profile_planner.bench_term_ids(128, 3_000)
    assert q.shape == (128, 4) and q.dtype == np.int32 and q.min() >= 51
    res = profile_planner.profile_plan(index, q, lib, repeats=2, ab=True)
    assert list(res["phases"]) == profile_planner.PHASES
    assert sum(p["share"] for p in res["phases"].values()) == pytest.approx(1.0)
    assert res["ms_per_query"] > 0 and res["width_max"] > 0 and res["prune_m"] == 128
    assert set(res["ab_ms_per_query"]) == {"bitmaps", "off"}
    assert profile_planner.report_lines(res)[0].startswith("A/B interleaved")

    for var, val in (("PROF_DOCS", "20000"), ("PROF_QUERIES", "64"), ("PROF_VOCAB", "3000"),
                     ("PROF_REPEATS", "1")):
        monkeypatch.setenv(var, val)
    out = tmp_path / "pp.json"
    assert profile_planner.main(["--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["backend"] == "cpu" and doc["card"] is None and doc["queries"] == 64
    lines = capsys.readouterr().out.splitlines()
    assert any(line.startswith("plan assembly:") for line in lines)
    assert sum("% of instrumented" in line for line in lines) == 5


def test_coalescer_core(served):
    retr, queries = served
    res = coalescer.coalescer_run(retr, queries, n_callers=3, seconds=0.3, reps=1)
    assert res["errors"] == [] and res["n_callers"] == 3
    assert res["served_b64_concurrent_qps"] > 0 and res["raw_b64_qps"] > 0
    assert res["fused_waves"] > 0 and 64 <= res["queries_per_wave"] <= 256


def test_coalescer_command(monkeypatch, tmp_path, capsys):
    for var, val in (("BENCH_DOCS", "2000"), ("BENCH_CALLERS", "2"), ("BENCH_SECONDS", "0.2")):
        monkeypatch.setenv(var, val)
    out = tmp_path / "co.json"
    assert coalescer.main(["--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc == json.loads(capsys.readouterr().out.splitlines()[-1])
    assert doc["backend"] == "cpu" and doc["kernel"] == "xla" and doc["metric"].startswith("coalesced_b64_qps")


def test_arrival_core(served):
    retr, queries = served
    res = arrival.arrival_curves(
        retr, queries[: 64 * 8], request_b=8, fractions=[0.5, 2.0], duration=0.3, max_batch=32,
    )
    assert res["direct_capacity_rps"] > 0 and res["coalesced_capacity_rps"] > 0
    for mode in ("direct", "coalesced"):
        pts = res["curves"][mode]
        assert [p["fraction_of_direct_cap"] for p in pts] == [0.5, 2.0]
        for p in pts:
            assert p["completed"] > 0 and p["errors"] == []
            assert p["p50_ms"] <= p["p95_ms"] <= p["p99_ms"]
    rows = arrival.markdown_rows(res["curves"])
    assert len(rows) == 4 and rows[2].startswith("| 0.5x |")


def test_encoder_quality_command_resumes_its_checkpoint(tmp_path, capsys):
    """Tables for both query sets and the reranker's uplift; a second run
    on the same ``--ckpt-dir`` resumes (no step runs) and measures the same
    tables; ``--rerank-only`` carries them from the JSON."""
    out = tmp_path / "eq.json"
    argv = [*EQ_ARGS, "--ckpt-dir", str(tmp_path / "ck"), "--out", str(out), "--platform", "cpu"]
    assert encoder_quality.main(argv) == 0
    first = json.loads(out.read_text())
    assert first["backend"] == "cpu" and first["encoder_step"] == 3 and first["train_steps_run"] == 3
    assert set(first["tables"]) == {"exact", "mismatch"}
    assert set(first["tables"]["exact"]) == {
        f"{e}-{m}" for e in ("hashing", "neural") for m in ("bm25", "dense", "hybrid")
    }
    assert set(first["rerank_uplift_exact"]) == {
        "first_stage_mrr@10", "reranked_mrr@10", "first_stage_recall@10", "reranked_recall@10",
    }
    assert encoder_quality.main(argv) == 0
    again = json.loads(out.read_text())
    assert again["train_steps_run"] == 0 and again["tables"] == first["tables"]
    assert encoder_quality.main([*argv, "--rerank-only"]) == 0
    assert json.loads(out.read_text())["tables"] == first["tables"]
    assert "| exact | hashing-bm25 |" in capsys.readouterr().out


def test_fusion_ab_core():
    from openintel_tpu_torch.index.synthetic import synthetic_synonym_corpus
    from openintel_tpu_torch.models.embedding import HashingEmbedder
    from openintel_tpu_torch.models.eval import synthetic_qrels

    docs, syn = synthetic_synonym_corpus(600, n_concepts=60, seed=41)
    qsets = {
        "exact": synthetic_qrels(docs, 30, seed=43),
        "mismatch": synthetic_qrels(docs, 30, seed=43, synonym_map=syn, flip_p=1.0),
    }
    tables = fusion_ab.fusion_tables(
        docs, qsets, [("hashing", HashingEmbedder(dim=32))], candidates=20, device=CPU,
        log=lambda m: None,
    )
    labels = [fusion_ab.arm_label(f, kw) for f, kw in fusion_ab.ARMS]
    assert labels == [
        "rrf(k=20)", "rrf(k=60)", "rrf(k=120)", "zblend(a=0.3)", "zblend(a=0.5)", "zblend(a=0.7)",
    ]
    assert list(tables["hashing"]) == labels
    for row in tables["hashing"].values():
        assert set(row) == {"exact", "mismatch"}
        assert 0.0 <= row["exact"]["mrr@10"] <= row["exact"]["recall@10"] <= 1.0
    assert tables["hashing"]["rrf(k=60)"]["exact"]["recall@10"] > 0.5


def test_sharded_overhead_core():
    """The 8-cell mesh of one device serves the single device's ids and
    reports the script's fields."""
    res = sharded_overhead.sharded_overhead(*sharded_overhead.overhead_inputs(8 * 2_048), CPU, reps=1)
    assert res["ids_equal_single"] is True
    assert res["allgather_bytes_per_batch_per_arm"] == 8 * 64 * 32 * 8
    assert res["overhead_ratio"] == res["t_sharded_8dev_ms"] / res["t_single_1dev_ms"] > 0
    assert res["matmul_probe_ratio"] > 0


@pytest.fixture(scope="module")
def operands():
    """16,000 docs x 64 (one super) and 256 near-doc queries, the scripts'
    generator."""
    emb, q = common.script_corpus(N_OPS, 256, near_docs=True, dim=64)
    rows, corpus, q8, qf = common.device_operands(emb, q, 1, 256, CPU)
    return emb, q, rows, corpus, q8[0], qf[0]


def test_batch_ab_core(operands):
    _, _, rows, corpus, q8, qf = operands
    out = batch_ab.batch_ab(corpus, rows, q8, qf, N_OPS, batches=(64, 128), reps=1)
    assert [r["label"] for r in out] == [
        "b=64 cand-only c=32", "b=128 cand-only c=32", "b=64 dense-arm c=32", "b=128 dense-arm c=32",
    ]
    assert [r["nb"] for r in out] == [4, 2, 4, 2]
    for r in out:
        assert 0 < r["ms_best"] <= r["ms_median"]
        assert common.row_line(r).startswith(r["label"])
    assert "4096/8192/16384" in batch_ab.block_width_note()


def test_int4_ab_core_against_the_oracle(operands):
    """Each variant's recall against the port's NumPy oracle; the block-width
    variants point at the program they share; scale 40 quantises apart."""
    emb, q, rows, corpus, q8, qf = operands
    from openintel_tpu_torch import convert

    corpora = {"int8": corpus, 32.0: convert.int4_corpus(rows), 40.0: convert.int4_corpus(rows, scale=40.0)}
    assert not torch.equal(corpora[32.0], corpora[40.0])
    ref_ids = int4_ab.oracle_ids(emb, q[:64])
    want = np.argsort(-(q[:64] @ emb.T), axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ref_ids, want)
    out = int4_ab.int4_ab(
        corpora, rows, q8.view(2, 128, -1), qf.view(2, 128, -1), N_OPS, ref_ids,
        variants=set(int4_ab.VARIANTS.split(",")), reps=1,
    )
    assert [r["label"] for r in out] == [
        "int8 (production)", "int4 c=128", "int4 c=256", "int4 c=128 s=40",
        "int4 c=256 bc=2048", "int4 c=256 bc=8192",
    ]
    assert [r.get("same_as") for r in out[4:]] == ["int4 c=256", "int4 c=256"]
    for r in out[:4]:
        assert r["recall"] >= 0.95, r
        assert int4_ab.row_line(r).startswith(r["label"])
    assert "not timed twice" in int4_ab.row_line(out[4])
    # the scale-40 variant's candidates are its own corpus's: the twin's
    _, got = T.dense_topk_fast_i4(corpora[40.0], q8[:128], k=128, n_docs=N_OPS, scale=40.0)
    _, other = T.dense_topk_fast_i4(corpora[32.0], q8[:128], k=128, n_docs=N_OPS)
    assert not torch.equal(got, other)


def test_int4_ab_alone_times_a_block_width_variant(operands):
    """A block-width variant asked for alone is timed under its own label."""
    emb, q, rows, corpus, q8, qf = operands
    from openintel_tpu_torch import convert

    out = int4_ab.int4_ab(
        {32.0: convert.int4_corpus(rows)}, rows, q8.view(2, 128, -1), qf.view(2, 128, -1),
        N_OPS, int4_ab.oracle_ids(emb, q[:16]), variants={"int4bc2048"}, reps=1,
    )
    assert [r["label"] for r in out] == ["int4 c=256 bc=2048"] and "same_as" not in out[0]


@pytest.mark.parametrize("tool,argv,n_rows", [
    (batch_ab, ["16000", "512"], 4),  # two of the script's widths, to keep the CPU run short
    (int4_ab, ["16000", "64", "2"], 6),
])
def test_ab_commands_print_rows_and_write_json(tool, argv, n_rows, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(batch_ab, "BATCHES", (256, 512))
    monkeypatch.setenv("AB_REPS", "1")
    monkeypatch.setenv("AB_SAMPLE", "32")
    out = tmp_path / "ab.json"
    assert tool.main([*argv, "--device", "cpu", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cpu: host clock")
    doc = json.loads(out.read_text())
    assert doc["backend"] == "cpu" and len(doc["rows"]) == n_rows
    assert sum(line.startswith(("b=", "int8", "int4")) for line in lines) == n_rows
