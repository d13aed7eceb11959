"""The port's CLI (``python -m openintel_tpu_torch.cli.main index|search``)
against the JAX package's ``openintel index|search`` on the same files.

``index`` writes the same arrays as the reference's (every postings array,
the rows: f32 equal, bf16 bit for bit), plain, ``--resume-dir`` and
``--append``. ``search`` over one saved index gives the reference's
``json`` output for every mode, kernel, fusion and filter flag (ids equal,
scores within 1e-4: the port's plain twins and the JAX program's Pallas
kernels in interpret mode sum in other orders), the same ``table``
output, and the same errors. Every port call runs with ``--device cpu``.
With a trained encoder (``--encoder``, one checkpoint for both CLIs,
trained by the port's ``train``, which the reference's ``load_embedder``
reads): ``index`` writes the reference's postings and its dense rows
within 1e-5 (f32; the encoders sum in other orders, about 1e-6 apart) or
one bf16 step (bf16), ``search`` gives the reference's output by the rule
above, and ``check_index_meta``'s three errors are the reference's. With
a cross-encoder checkpoint (one for both CLIs) ``search --rerank`` gives
the reference's output (ids equal, scores within 1e-4) and its error
without the docs sidecar; ``train --reranker``/``--analyzer`` print the
reference's log lines (the losses are the port's own draws) and write
checkpoints the reference loads; from the same encoder checkpoint and the
same heads, their final losses agree within 1e-4. ``search --mesh``
(ROADMAP item 13) fails on a bad spec as the reference does. ``train
--mesh 2x4`` prints the reference's log lines (each side's losses
masked) and writes a checkpoint the other package loads, with the
analyzer and reranker heads too; a bad spec or a model axis that does
not divide the heads fails with the reference's exit code and text.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from openintel_tpu.cli.main import main as jmain
from openintel_tpu.cli.main import parse_id_list as jparse
from openintel_tpu.index import checkpoint as jck
from openintel_tpu_torch.cli.main import main as tmain
from openintel_tpu_torch.cli.main import parse_id_list as tparse
from openintel_tpu_torch.index import checkpoint as tck
from openintel_tpu_torch.index.synthetic import synthetic_token_corpus

TOL = 1e-4
QUERIES = ["t3 t17 t90", "t5 t8", "t140 t2 t2", "no such words"]
POSTINGS_FIELDS = ("term_offsets", "doc_ids", "tf", "impact", "df", "idf", "doc_len")


def _run(capsys, fn, *argv):
    code = fn(list(argv))
    captured = capsys.readouterr()
    return captured.out + captured.err, code


def port(capsys, *argv):
    argv = list(argv)
    if argv[0] in ("search", "index", "train"):
        argv += ["--device", "cpu"]
    return _run(capsys, tmain, *argv)


def ref(capsys, *argv):
    return _run(capsys, jmain, *argv)


def _words(emb):
    if isinstance(emb, torch.Tensor):
        return emb.view(torch.int16).numpy().view(np.uint16) if emb.dtype == torch.bfloat16 else emb.numpy()
    arr = np.asarray(emb)
    return arr.view(np.uint16) if arr.dtype == np.dtype(ml_dtypes.bfloat16) else arr


def _assert_same_index(t_prefix, j_prefix, tol=None):
    """Every postings array and sidecar equal; the dense rows equal, or
    with ``tol`` within it (f32) or within one bf16 step, at most 2**-7
    relative (bf16: a value near a rounding boundary may round the other
    way)."""
    tp, jp = tck.load_postings(f"{t_prefix}.postings.npz"), jck.load_postings(f"{j_prefix}.postings.npz")
    for name in POSTINGS_FIELDS:
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name), err_msg=name)
    assert tp.vocab.token_to_id == jp.vocab.token_to_id and tp.avgdl == jp.avgdl
    td, jd = tck.load_dense(f"{t_prefix}.dense.npz"), jck.load_dense(f"{j_prefix}.dense.npz")
    if tol is None:
        np.testing.assert_array_equal(_words(td.embeddings), _words(jd.embeddings))
    else:
        got = np.asarray(td.embeddings.float() if isinstance(td.embeddings, torch.Tensor) else td.embeddings, np.float32)
        want = np.asarray(jd.embeddings, np.float32)
        bf16 = _words(jd.embeddings).dtype == np.uint16
        np.testing.assert_allclose(got, want, rtol=2.0**-7 if bf16 else 0, atol=0 if bf16 else tol)
    for suffix in (".meta.json", ".docs.txt"):
        with open(f"{t_prefix}{suffix}") as a, open(f"{j_prefix}{suffix}") as b:
            assert a.read() == b.read(), suffix


def _assert_same_json(got_out, want_out):
    got, want = json.loads(got_out), json.loads(want_out)
    assert [r["query"] for r in got] == [r["query"] for r in want]
    for g, w in zip(got, want):
        assert [h["doc_id"] for h in g["hits"]] == [h["doc_id"] for h in w["hits"]], g["query"]
        assert [h.get("text") for h in g["hits"]] == [h.get("text") for h in w["hits"]]
        np.testing.assert_allclose(
            [h["score"] for h in g["hits"]], [h["score"] for h in w["hits"]], rtol=0, atol=TOL
        )


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    """One corpus file indexed by both CLIs (f32 and bf16 stores); the
    port's search runs over the reference's index and the reference's over
    the port's."""
    d = tmp_path_factory.mktemp("cli")
    corpus = d / "corpus.txt"
    corpus.write_text("\n".join(synthetic_token_corpus(240, vocab_size=160, seed=41)) + "\n")
    return d, corpus


def _index_both(capsys, d, corpus, *flags, name="idx"):
    """Both CLIs index ``corpus``; a ``{side}`` in a flag becomes t or j."""
    out = {}
    for side, fn in (("t", port), ("j", ref)):
        argv = [f.replace("{side}", side) for f in flags]
        text, code = fn(capsys, "index", str(corpus), "--out", str(d / f"{side}_{name}"), *argv)
        out[side] = (code, text.replace(f"/{side}_", "/_"))
    assert out["t"] == out["j"]
    return d / f"t_{name}", d / f"j_{name}"


@pytest.mark.parametrize("flags", [[], ["--dense-store", "bf16"], ["--bf16"], ["--dense-store", "f32"]])
def test_index_writes_the_reference_arrays(indexed, capsys, flags):
    d, corpus = indexed
    t, j = _index_both(capsys, d, corpus, "--dim", "48", *flags, name="i" + "".join(flags))
    _assert_same_index(t, j)


def test_index_resume_dir_and_append_write_the_reference_arrays(indexed, capsys, tmp_path):
    d, corpus = indexed
    t, j = _index_both(
        capsys, tmp_path, corpus, "--dim", "32", "--bf16", "--chunk-docs", "64",
        "--resume-dir", str(tmp_path / "{side}_ck"), name="res",
    )
    _assert_same_index(t, j)
    extra = tmp_path / "extra.txt"
    extra.write_text("fresh zebra document\nanother zebra story\n")
    t_out, t_code = port(capsys, "index", str(extra), "--out", str(t), "--append")
    j_out, j_code = ref(capsys, "index", str(extra), "--out", str(j), "--append")
    assert t_code == j_code == 0 and "appended 2 docs (ids 240..241)" in t_out
    assert t_out.replace(str(t), str(j)) == j_out
    _assert_same_index(t, j)


def test_index_errors_match_the_reference(indexed, capsys, tmp_path):
    d, corpus = indexed
    empty = tmp_path / "empty.txt"
    empty.write_text("\n  \n")
    cases = [
        ["index", str(empty), "--out", str(tmp_path / "e")],
        ["index", str(corpus), "--out", str(tmp_path / "b"), "--bf16", "--dense-store", "f32"],
        ["index", str(corpus), "--out", str(tmp_path / "nope"), "--append"],
        ["index", str(corpus), "--out", str(tmp_path / "x"), "--append", "--resume-dir", "r"],
    ]
    for argv in cases:
        t_out, t_code = port(capsys, *argv)
        j_out, j_code = ref(capsys, *argv)
        assert t_code == j_code == 1 and t_out == j_out, argv
    t, j = _index_both(capsys, tmp_path, corpus, "--dim", "16", name="st")
    for prefix, fn in ((t, port), (j, ref)):
        out, code = fn(capsys, "index", str(corpus), "--out", str(prefix), "--append", "--bf16")
        assert code == 1 and "--append keeps the existing precision" in out
    # --encoder on a missing checkpoint: the same "file not found"
    argv = ["index", str(corpus), "--out", str(tmp_path / "n"), "--encoder", str(tmp_path / "nock")]
    t_out, t_code = port(capsys, *argv)
    j_out, j_code = ref(capsys, *argv)
    assert t_code == j_code == 1 and t_out == j_out and "file not found" in t_out


KERNELS = ["auto", "xla", "pallas", "fast", "int8", "int4"]
FILTERS = {"none": [], "exclude": ["--exclude-ids", "0-9,33"], "include": ["--include-ids", "5-120"]}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("served")
    corpus = d / "corpus.txt"
    corpus.write_text("\n".join(synthetic_token_corpus(240, vocab_size=160, seed=41)) + "\n")
    prefix = d / "idx"
    assert jmain(["index", str(corpus), "--out", str(prefix), "--dim", "48"]) == 0
    return prefix


@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize(
    "mode,kernel", [("bm25", "auto")] + [(m, k) for m in ("hybrid", "dense") for k in KERNELS]
)
def test_search_json_matches_the_reference(served, capsys, mode, kernel, filt):
    argv = [
        "search", *QUERIES, "--index", str(served), "-k", "7", "--format", "json",
        "--mode", mode, "--kernel", kernel, *FILTERS[filt],
    ]
    t_out, t_code = port(capsys, *argv)
    j_out, j_code = ref(capsys, *argv)
    assert t_code == j_code == 0, t_out
    _assert_same_json(t_out, j_out)


@pytest.mark.parametrize(
    "fusion", [["--fusion", "rrf"], ["--blend-alpha", "0.5"], ["--blend-alpha", "1.0"]]
)
def test_search_fusion_flags_match_the_reference(served, capsys, fusion):
    argv = ["search", *QUERIES, "--index", str(served), "-k", "5", "--format", "json", *fusion]
    t_out, _ = port(capsys, *argv)
    j_out, _ = ref(capsys, *argv)
    _assert_same_json(t_out, j_out)


def test_search_table_matches_the_reference(served, capsys):
    for mode in ("bm25", "hybrid"):
        argv = ["search", *QUERIES, "--index", str(served), "-k", "4", "--mode", mode]
        t_out, t_code = port(capsys, *argv)
        j_out, j_code = ref(capsys, *argv)
        assert t_code == j_code == 0 and t_out == j_out


def test_search_errors_match_the_reference(served, capsys, tmp_path):
    cases = [
        ["--fusion", "rrf", "--blend-alpha", "0.5"],
        ["--blend-alpha", "1.5"],
        ["--exclude-ids", "abc"],
        ["--exclude-ids", "999"],
        ["--include-ids", ""],
        ["--exclude-ids", "0-9999999999"],
        ["--include-ids", "9-5"],
    ]
    for flags in cases:
        argv = ["search", "t3", "--index", str(served), *flags]
        t_out, t_code = port(capsys, *argv)
        j_out, j_code = ref(capsys, *argv)
        assert t_code == j_code == 1 and t_out == j_out, flags
    missing = ["search", "x", "--index", str(tmp_path / "nope")]
    t_out, t_code = port(capsys, *missing)
    j_out, j_code = ref(capsys, *missing)
    assert t_code == j_code == 1 and t_out == j_out
    # an index embedded by a trained encoder needs --encoder
    for suffix in (".postings.npz", ".postings.vocab.json", ".dense.npz", ".dense.emb.npy"):
        (tmp_path / f"neural{suffix}").write_bytes((served.parent / f"idx{suffix}").read_bytes())
    (tmp_path / "neural.meta.json").write_text(json.dumps({"embedder": "neural", "dim": 48}))
    argv = ["search", "t3", "--index", str(tmp_path / "neural")]
    t_out, t_code = port(capsys, *argv)
    j_out, j_code = ref(capsys, *argv)
    assert t_code == j_code == 1 and t_out == j_out and "trained encoder" in t_out


@pytest.mark.parametrize("flag,item", [("--mesh", 13)])
def test_unported_search_flags_are_refused(served, capsys, flag, item):
    """``search``'s last refused flag, ``--mesh`` (ROADMAP item 13), is
    ported: a bad spec fails with the reference's exit code and text."""
    out, code = port(capsys, "search", "t3", "--index", str(served), flag, "x")
    j_out, j_code = ref(capsys, "search", "t3", "--index", str(served), flag, "x")
    assert code == j_code == 1 and out == j_out
    assert out.startswith(f"error: {flag} x: ") and f"item {item}" not in out


def test_parse_id_list_matches_the_reference():
    for spec in (None, "3,5,9", "10-13", "3, 10-12 ,512", "-1", "0"):
        assert tparse(spec) == jparse(spec)
    for spec, n in (("", None), ("3,abc", None), ("9-5", None), ("0-10", 5), (",", None)):
        with pytest.raises(ValueError) as t_err:
            tparse(spec, n)
        with pytest.raises(ValueError) as j_err:
            jparse(spec, n)
        assert str(t_err.value) == str(j_err.value)


def test_search_runs_on_the_card_unless_asked(served, capsys, monkeypatch):
    """Without ``--device cpu`` a search goes to the card; with no card it
    fails with CUDA's own error, never quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        tmain(["search", "t3", "--index", str(served), "--kernel", "xla"])


# ---------- a trained encoder (--encoder, train) ----------

ENC_TOL = 1e-5


@pytest.fixture(scope="module")
def encoder(indexed):
    """Two checkpoints trained by the port's ``train`` on the corpus: 32
    and 16 wide (the second for the width-mismatch error)."""
    d, corpus = indexed
    for dim, steps in (("32", "3"), ("16", "1")):
        code = tmain(["train", str(corpus), "--out", str(d / f"enc{dim}"), "--dim", dim,
                      "--depth", "1", "--heads", "2", "--steps", steps, "--batch-size", "8",
                      "--device", "cpu"])
        assert code == 0
    return d / "enc32", d / "enc16"


def test_port_train_checkpoint_loads_in_the_reference(encoder, capsys):
    from openintel_tpu.models.train import load_embedder as jload
    from openintel_tpu_torch.models.train import load_embedder as tload

    texts = ["t3 t17 t90", "t5", ""]
    for ck in encoder:
        np.testing.assert_allclose(
            tload(ck, device="cpu")(texts), jload(ck)(texts), rtol=0, atol=ENC_TOL
        )
    out, code = port(capsys, "train", "nope.txt", "--out", str(encoder[0]))
    assert code == 1 and out.strip() == "error: file not found: nope.txt"


MESH_TRAIN = ["--dim", "32", "--depth", "1", "--heads", "4", "--steps", "4", "--batch-size", "8"]


def test_train_mesh_prints_the_reference_lines(indexed, capsys, tmp_path):
    """``train --mesh 2x4`` on both CLIs (the port's on 8 host stand-ins,
    the reference's on conftest's 8 virtual devices): the same log lines
    up to the loss digits, the same files, and each checkpoint serves in
    the other package."""
    from openintel_tpu.models.train import load_embedder as jload
    from openintel_tpu_torch.models.train import load_embedder as tload

    d, corpus = indexed
    outs = {}
    for side, fn in (("t", port), ("j", ref)):
        text, code = fn(capsys, "train", str(corpus), "--out", str(tmp_path / side), "--mesh", "2x4", *MESH_TRAIN)
        assert code == 0, text
        outs[side] = _mask_numbers(text.replace(str(tmp_path / side), "CK"))
    assert outs["t"] == outs["j"] and outs["t"].startswith("mesh: data=2 x model=4\n")
    with np.load(tmp_path / "t" / "encoder.npz") as a, np.load(tmp_path / "j" / "encoder.npz") as b:
        assert {k: a[k].shape for k in a.files} == {k: b[k].shape for k in b.files}
    texts = ["t3 t17 t90", "t5", ""]
    for side in ("t", "j"):
        np.testing.assert_allclose(
            tload(tmp_path / side, device="cpu")(texts), jload(tmp_path / side)(texts), rtol=0, atol=ENC_TOL
        )


@pytest.mark.parametrize("spec", ["x", "0x4", "1x3"])
def test_train_mesh_errors_match_the_reference(indexed, capsys, tmp_path, spec):
    """A spec that does not parse, a zero axis, and a model axis of 3 that
    does not divide 4 heads: exit 1 and the reference's text, no
    checkpoint."""
    d, corpus = indexed
    got = port(capsys, "train", str(corpus), "--out", str(tmp_path / "t"), "--mesh", spec, *MESH_TRAIN)
    want = ref(capsys, "train", str(corpus), "--out", str(tmp_path / "j"), "--mesh", spec, *MESH_TRAIN)
    assert got[1] == want[1] == 1 and got[0] == want[0] and got[0].startswith("error: ")
    assert not (tmp_path / "t").exists()


def test_train_mesh_with_heads_writes_loadable_heads(indexed, capsys, tmp_path):
    """``train --mesh 2x4 --analyzer --reranker``: the gathered encoder
    hands off to both heads, which are written and load in both
    packages."""
    from openintel_tpu.models.neural_analyzer import load_analyzer
    from openintel_tpu.models.reranker import load_reranker
    from openintel_tpu_torch.models.neural_analyzer import load_analyzer as t_load_analyzer
    from openintel_tpu_torch.models.reranker import load_reranker as t_load_reranker

    d, corpus = indexed
    text, code = port(capsys, "train", str(corpus), "--out", str(tmp_path), "--mesh", "2x4", *MESH_TRAIN,
                      "--analyzer", "--reranker")
    assert code == 0, text
    assert "analyzer head distilled (20 steps" in text and "reranker trained (10 steps" in text
    texts = ["moon calls", "crash dump puts"]
    np.testing.assert_allclose(
        [s.polarity.value for s in load_analyzer(tmp_path).score_texts(texts)],
        [s.polarity.value for s in t_load_analyzer(tmp_path, device="cpu").score_texts(texts)],
        rtol=0, atol=1e-5,
    )
    assert load_reranker(tmp_path).cfg.dim == t_load_reranker(tmp_path, device="cpu").cfg.dim == 32


@pytest.mark.parametrize("flags", [[], ["--bf16"], ["--chunk-docs", "64", "--resume-dir", "{side}_rck"]])
def test_index_encoder_writes_the_reference_arrays(indexed, encoder, capsys, tmp_path, flags):
    d, corpus = indexed
    flags = [f.replace("{side}_", str(tmp_path / "{side}_")) for f in flags]
    t, j = _index_both(capsys, tmp_path, corpus, "--encoder", str(encoder[0]), *flags, name="enc")
    _assert_same_index(t, j, tol=ENC_TOL)
    assert json.loads((tmp_path / "t_enc.meta.json").read_text())["embedder"] == "neural"


def test_index_encoder_append_writes_the_reference_arrays(indexed, encoder, capsys, tmp_path):
    d, corpus = indexed
    t, j = _index_both(capsys, tmp_path, corpus, "--encoder", str(encoder[0]), name="app")
    extra = tmp_path / "extra.txt"
    extra.write_text("fresh zebra document\nanother zebra story t3\n")
    argv = ["index", str(extra), "--append", "--encoder", str(encoder[0])]
    t_out, t_code = port(capsys, *argv, "--out", str(t))
    j_out, j_code = ref(capsys, *argv, "--out", str(j))
    assert t_code == j_code == 0 and t_out.replace(str(t), str(j)) == j_out
    _assert_same_index(t, j, tol=ENC_TOL)


@pytest.fixture(scope="module")
def neural_index(indexed, encoder):
    """The reference's ``index --encoder`` over the corpus."""
    d, corpus = indexed
    prefix = d / "neural_idx"
    assert jmain(["index", str(corpus), "--out", str(prefix), "--encoder", str(encoder[0])]) == 0
    return prefix


@pytest.mark.parametrize(
    "mode,kernel", [("bm25", "auto"), ("dense", "xla"), ("hybrid", "auto"), ("hybrid", "int8"), ("hybrid", "pallas")]
)
def test_search_encoder_matches_the_reference(neural_index, encoder, capsys, mode, kernel):
    argv = [
        "search", *QUERIES, "--index", str(neural_index), "--encoder", str(encoder[0]),
        "-k", "7", "--format", "json", "--mode", mode, "--kernel", kernel,
    ]
    t_out, t_code = port(capsys, *argv)
    j_out, j_code = ref(capsys, *argv)
    assert t_code == j_code == 0, t_out
    _assert_same_json(t_out, j_out)


def test_index_meta_errors_match_the_reference(neural_index, served, encoder, capsys, indexed):
    """``check_index_meta``'s three errors, on ``search`` and ``index
    --append``: a neural index without ``--encoder``, a hashing index
    with it, and a checkpoint of another width."""
    d, corpus = indexed
    cases = [
        ("trained encoder", ["search", "t3", "--index", str(neural_index)]),
        ("hashing embedder", ["search", "t3", "--index", str(served), "--encoder", str(encoder[0])]),
        ("embedded at 32d but the encoder checkpoint embeds at 16d",
         ["search", "t3", "--index", str(neural_index), "--encoder", str(encoder[1])]),
        ("embedded at 32d but the encoder checkpoint embeds at 16d",
         ["index", str(corpus), "--out", str(neural_index), "--append", "--encoder", str(encoder[1])]),
        ("hashing embedder",
         ["index", str(corpus), "--out", str(served), "--append", "--encoder", str(encoder[0])]),
    ]
    for needle, argv in cases:
        t_out, t_code = port(capsys, *argv)
        j_out, j_code = ref(capsys, *argv)
        assert t_code == j_code == 1 and t_out == j_out and needle in t_out, argv


# ---------- the cross-encoder (--rerank, train --reranker/--analyzer) ----------


@pytest.fixture(scope="module")
def rerank_ck(tmp_path_factory):
    """A reranker checkpoint written by the reference (vocab 256, dim 32,
    depth 1, max_len 32), which both CLIs load."""
    from openintel_tpu.models.encoder import EncoderConfig as JConfig
    from openintel_tpu.models.reranker import CrossEncoderReranker as JRR
    from openintel_tpu.models.reranker import save_reranker as jsave

    d = tmp_path_factory.mktemp("rerank")
    jsave(JRR(JConfig(vocab_size=256, dim=32, depth=1, heads=2, max_len=32), seed=2), d)
    return d


@pytest.mark.parametrize("flags", [
    ["--format", "json"], ["--format", "json", "--mode", "bm25", "-k", "4"],
    ["--format", "json", "--kernel", "int8", "--exclude-ids", "0-9"], [],
])
def test_search_rerank_matches_the_reference(served, rerank_ck, capsys, flags):
    argv = ["search", *QUERIES, "--index", str(served), "--rerank", str(rerank_ck), *flags]
    t_out, t_code = port(capsys, *argv)
    j_out, j_code = ref(capsys, *argv)
    assert t_code == j_code == 0, t_out
    if "json" in flags:
        _assert_same_json(t_out, j_out)
    else:
        assert t_out == j_out


def test_search_rerank_needs_the_docs_sidecar(served, rerank_ck, capsys, tmp_path):
    for suffix in (".postings.npz", ".postings.vocab.json", ".dense.npz", ".dense.emb.npy", ".meta.json"):
        (tmp_path / f"bare{suffix}").write_bytes((served.parent / f"idx{suffix}").read_bytes())
    argv = ["search", "t3", "--index", str(tmp_path / "bare"), "--rerank", str(rerank_ck)]
    t_out, t_code = port(capsys, *argv)
    j_out, j_code = ref(capsys, *argv)
    assert t_code == j_code == 1 and t_out == j_out
    assert t_out.strip() == "error: --rerank needs the index's .docs.txt sidecar"


def test_search_rerank_with_an_encoder_matches_the_reference(neural_index, encoder, rerank_ck, capsys):
    argv = [
        "search", *QUERIES, "--index", str(neural_index), "--encoder", str(encoder[0]),
        "--rerank", str(rerank_ck), "-k", "5", "--format", "json",
    ]
    t_out, t_code = port(capsys, *argv)
    j_out, j_code = ref(capsys, *argv)
    assert t_code == j_code == 0, t_out
    _assert_same_json(t_out, j_out)


def _mask_numbers(text: str) -> str:
    import re

    return re.sub(r"-?\d+\.\d{4}", "X", text)


def test_train_reranker_and_analyzer_print_the_reference_lines(indexed, capsys, tmp_path):
    """Both CLIs train the encoder, the analyzer head and the reranker;
    the log lines are the reference's (each side's own losses masked), the
    files the same, and the port's heads load in the reference."""
    from openintel_tpu.models.neural_analyzer import load_analyzer
    from openintel_tpu.models.reranker import load_reranker
    from openintel_tpu_torch.models.neural_analyzer import load_analyzer as t_load_analyzer

    d, corpus = indexed
    outs = {}
    for side, fn in (("t", port), ("j", ref)):
        text, code = fn(capsys, "train", str(corpus), "--out", str(tmp_path / side), "--dim", "32",
                        "--depth", "1", "--heads", "2", "--steps", "4", "--batch-size", "8",
                        "--reranker", "--analyzer")
        assert code == 0, text
        outs[side] = _mask_numbers(text.replace(str(tmp_path / side), "CK"))
    assert outs["t"] == outs["j"]
    assert "analyzer head distilled (20 steps" in outs["t"] and "reranker trained (10 steps" in outs["t"]
    for name in ("encoder", "analyzer", "reranker"):
        with np.load(tmp_path / "t" / f"{name}.npz") as a, np.load(tmp_path / "j" / f"{name}.npz") as b:
            assert sorted(a.files) == sorted(b.files), name
    texts = ["moon calls", "crash dump puts"]
    np.testing.assert_allclose(
        [s.polarity.value for s in load_analyzer(tmp_path / "t").score_texts(texts)],
        [s.polarity.value for s in t_load_analyzer(tmp_path / "t", device="cpu").score_texts(texts)],
        rtol=0, atol=1e-5,
    )
    assert load_reranker(tmp_path / "t").cfg.dim == 32


def test_train_heads_from_one_start_match_the_reference(indexed, capsys, tmp_path, monkeypatch):
    """One encoder checkpoint (the reference's, at step 2) resumed for one
    step by each CLI, and the same analyzer and reranker heads: the final
    losses of ``--analyzer`` (20 steps) and ``--reranker`` (10 steps)
    agree within 1e-4, and so do the saved encoders (1e-5). (The
    reference's ``--analyzer`` fails on a checkpoint already at its
    steps: its loaded params are numpy arrays, which its jitted step
    cannot index; the port's does not, so this test resumes a step.)"""
    import re
    import shutil

    import jax

    from openintel_tpu.models import neural_analyzer as JN
    from openintel_tpu.models import reranker as JR
    from openintel_tpu.models.encoder import EncoderConfig as JConfig
    from openintel_tpu.models.encoder import init_analyzer_head as j_analyzer_head
    from openintel_tpu_torch import convert
    from openintel_tpu_torch.models import neural_analyzer as TN
    from openintel_tpu_torch.models import reranker as TR

    d, corpus = indexed
    assert jmain(["train", str(corpus), "--out", str(tmp_path / "j"), "--dim", "32", "--depth", "1",
                  "--heads", "2", "--steps", "2", "--batch-size", "8"]) == 0
    capsys.readouterr()
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jcfg = JConfig(dim=32, depth=1, heads=2)
    a_head = j_analyzer_head(jax.random.PRNGKey(11), jcfg)
    r_head = JR.init_rerank_head(jax.random.PRNGKey(12), jcfg)
    monkeypatch.setattr(JN, "init_analyzer_head", lambda key, cfg: a_head)
    monkeypatch.setattr(JR, "init_rerank_head", lambda key, cfg: r_head)
    t_a = convert.head_params(jax.tree_util.tree_map(np.asarray, a_head))
    t_r = convert.head_params(jax.tree_util.tree_map(np.asarray, r_head))
    monkeypatch.setattr(TN, "init_analyzer_head", lambda gen, cfg, device=None: {k: v.clone() for k, v in t_a.items()})
    monkeypatch.setattr(TR, "init_rerank_head", lambda gen, cfg, device=None: {k: v.clone() for k, v in t_r.items()})
    losses = {}
    for side, fn in (("t", port), ("j", ref)):
        text, code = fn(capsys, "train", str(corpus), "--out", str(tmp_path / side), "--dim", "32",
                        "--depth", "1", "--heads", "2", "--steps", "3", "--batch-size", "8",
                        "--reranker", "--analyzer")
        assert code == 0, text
        assert "resumed from step 2" in text and "analyzer head distilled (20 steps" in text
        losses[side] = [float(x) for x in re.findall(r"final loss (-?\d+\.\d+)", text)]
    assert len(losses["t"]) == 3
    np.testing.assert_allclose(losses["t"], losses["j"], rtol=0, atol=1e-4)
    with np.load(tmp_path / "t" / "encoder.npz") as a, np.load(tmp_path / "j" / "encoder.npz") as b:
        for key in a.files:
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5, err_msg=key)
