"""The port's encoder training and checkpoints
(``openintel_tpu_torch.models.train``, ``models.checkpoint``) against the
JAX package's, on the CPU at small configs.

Checkpoints cross in both directions exactly (the reference's npz keys,
optax's ``count``/``mu``/``nu`` as AdamW's state); a run resumed in either
package from the other's checkpoint follows the same batches, and its
losses and weights agree with the reference's resume to 1e-5 (relative
for the losses; the products sum in other orders: the first runs differ
by about 1e-6 and 4e-7). A JAX-trained checkpoint served by the port's
``load_embedder`` embeds within 1e-5 of the reference's. ``make_pairs``
draws the reference's batches bit for bit. Every test of
``tests/test_train.py`` has a counterpart here but the mesh one, whose
counterparts are in ``tests/test_torch_tensor_parallel.py``.
"""

import filecmp
import shutil

import jax
import numpy as np
import pytest
import torch

from openintel_tpu.index import synthetic as jsyn
from openintel_tpu.models import checkpoint as jck
from openintel_tpu.models import encoder as JE
from openintel_tpu.models import train as JT
from openintel_tpu_torch import convert
from openintel_tpu_torch.index.synthetic import (
    flip_tokens,
    synthetic_synonym_corpus,
    synthetic_template_corpus,
)
from openintel_tpu_torch.models import checkpoint as tck
from openintel_tpu_torch.models.encoder import EncoderConfig, Encoder, NeuralEmbedder, init_params
from openintel_tpu_torch.models.train import (
    load_embedder,
    make_pairs,
    state_tree,
    train_encoder,
)

TOL = 1e-5
CPU = "cpu"
KW = dict(vocab_size=256, dim=32, depth=1, heads=2, max_len=16)
CFG = EncoderConfig(**KW)
JCFG = JE.EncoderConfig(**KW)
TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "lazy dogs sleep all day long in the sun",
    "market speculation calls puts options yolo",
    "earnings report scheduled for tuesday morning",
    "rocket moon breakout bull run momentum",
    "bearish drill crash dump sell everything",
] * 3


def test_training_reduces_loss():
    res = train_encoder(TEXTS, CFG, steps=15, batch_size=6, lr=3e-3, seed=1, device=CPU)
    assert len(res.losses) == 15
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])


def test_checkpoint_roundtrip_exact(tmp_path):
    model = init_params(torch.Generator().manual_seed(3), CFG)
    tree = state_tree(model)
    tck.save_params(tree, tmp_path / "enc", config=CFG, step=7)
    loaded = tck.load_params(tree, tmp_path / "enc")
    want, got = tck.flatten(tree), tck.flatten(loaded)
    assert set(want) == set(got)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert tck.load_meta(tmp_path / "enc")["step"] == 7
    assert tck.load_meta(tmp_path / "enc")["config"]["dim"] == CFG.dim
    assert sorted(p.name for p in tmp_path.iterdir()) == ["enc.json", "enc.npz"]


def _jstate(params):
    import optax

    return {"params": params, "opt": optax.adamw(1e-3).init(params)}


@pytest.mark.parametrize("cfg_kw", [KW, {}])  # {}: the default config, 109 keys
def test_key_set_equals_the_reference(cfg_kw):
    """The port's checkpoint tree has the reference's keys, shapes and
    dtypes: at the default config 36 params, the count, 36 mu, 36 nu."""
    shapes = jax.eval_shape(lambda: _jstate(JE.init_params(jax.random.PRNGKey(0), JE.EncoderConfig(**cfg_kw))))
    want = {
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): (leaf.shape, leaf.dtype)
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
    }
    got = {k: (v.shape, v.dtype) for k, v in tck.flatten(state_tree(Encoder(EncoderConfig(**cfg_kw)))).items()}
    assert got == want
    if not cfg_kw:
        assert len(got) == 109 and sum(k.startswith("params/") for k in got) == 36


def test_port_checkpoint_loads_exactly_in_the_reference(tmp_path):
    res = train_encoder(TEXTS, CFG, steps=2, batch_size=4, seed=5, ckpt_dir=tmp_path, device=CPU)
    template = _jstate(JE.init_params(jax.random.PRNGKey(0), JCFG))
    loaded = jck.load_params(template, tmp_path / "encoder")
    got = tck.flatten(jax.tree_util.tree_map(np.asarray, loaded))
    with np.load(tmp_path / "encoder.npz") as data:
        want = dict(data)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert int(got["opt/0/.count"]) == 2
    params = convert.encoder_tree(res.params)
    for key, value in tck.flatten(params).items():
        np.testing.assert_array_equal(got[f"params/{key}"], value)
    assert jck.load_meta(tmp_path / "encoder") == {"config": {**KW, "mlp_ratio": 4, "dtype": "float32"}, "step": 2}


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A checkpoint of 3 steps of the reference's training."""
    d = tmp_path_factory.mktemp("jax_ck")
    JT.train_encoder(TEXTS, JCFG, steps=3, batch_size=6, lr=3e-3, seed=2, ckpt_dir=d, ckpt_every=100)
    return d


def test_reference_checkpoint_loads_exactly_in_the_port(jax_ckpt):
    loaded = tck.load_params(state_tree(Encoder(CFG)), jax_ckpt / "encoder")
    got = tck.flatten(loaded)
    with np.load(jax_ckpt / "encoder.npz") as data:
        assert set(got) == set(data.files)
        for key in data.files:
            assert got[key].dtype == data[key].dtype
            np.testing.assert_array_equal(got[key], data[key])
    assert int(loaded["opt"][0].count) == 3


def test_mismatched_checkpoint_is_refused(tmp_path, jax_ckpt):
    wider = Encoder(EncoderConfig(**{**KW, "dim": 48}))
    with pytest.raises(tck.CheckpointMismatchError, match="shape"):
        tck.load_params(state_tree(wider), jax_ckpt / "encoder")
    deeper = Encoder(EncoderConfig(**{**KW, "depth": 2}))
    with pytest.raises(tck.CheckpointMismatchError, match="structure"):
        tck.load_params(state_tree(deeper), jax_ckpt / "encoder")
    # params without the optimizer's state: refused by both packages
    tck.save_params({"params": state_tree(Encoder(CFG))["params"]}, tmp_path / "encoder", config=CFG)
    with pytest.raises(AssertionError):
        load_embedder(tmp_path, device=CPU)
    with pytest.raises(AssertionError):
        JT.load_embedder(tmp_path)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_packages(tmp_path, jax_ckpt, first):
    """One package trains 3 steps to a checkpoint; the directory is copied
    and both packages resume it to step 6: the same losses and weights."""
    if first == "jax":
        shutil.copytree(jax_ckpt, tmp_path / "a")
    else:
        train_encoder(TEXTS, CFG, steps=3, batch_size=6, lr=3e-3, seed=2,
                      ckpt_dir=tmp_path / "a", ckpt_every=100, device=CPU)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    want = JT.train_encoder(TEXTS, JCFG, steps=6, batch_size=6, lr=3e-3, seed=2,
                            ckpt_dir=tmp_path / "a", ckpt_every=100)
    logs = []
    got = train_encoder(TEXTS, CFG, steps=6, batch_size=6, lr=3e-3, seed=2,
                        ckpt_dir=tmp_path / "b", ckpt_every=100, log=logs.append, device=CPU)
    assert "resumed from step 3" in logs
    assert len(got.losses) == len(want.losses) == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=TOL)
    with np.load(tmp_path / "a" / "encoder.npz") as a, np.load(tmp_path / "b" / "encoder.npz") as b:
        assert set(a.files) == set(b.files)
        assert int(a["opt/0/.count"]) == int(b["opt/0/.count"]) == 6
        for key in a.files:
            np.testing.assert_allclose(b[key], a[key], rtol=0, atol=TOL, err_msg=key)
    assert tck.load_meta(tmp_path / "b" / "encoder") == jck.load_meta(tmp_path / "a" / "encoder")


def test_resume_continues_from_checkpoint(tmp_path):
    train_encoder(TEXTS, CFG, steps=6, batch_size=4, seed=2, ckpt_dir=tmp_path, ckpt_every=3, device=CPU)
    logs = []
    res = train_encoder(TEXTS, CFG, steps=10, batch_size=4, seed=2, ckpt_dir=tmp_path,
                        ckpt_every=100, log=logs.append, device=CPU)
    assert any("resumed from step 6" in m for m in logs)
    assert len(res.losses) == 4  # only steps 6..9 run
    assert tck.load_meta(tmp_path / "encoder")["step"] == 10


def test_resume_at_or_past_the_request_does_nothing(tmp_path):
    """The reference's no-op: nothing runs and the meta keeps its step
    (the files are not rewritten)."""
    train_encoder(TEXTS, CFG, steps=6, batch_size=4, seed=2, ckpt_dir=tmp_path, device=CPU)
    shutil.copytree(tmp_path, tmp_path.parent / "before")
    res = train_encoder(TEXTS, CFG, steps=4, batch_size=4, seed=2, ckpt_dir=tmp_path, device=CPU)
    assert res.losses == [] and res.step == 6
    for name in ("encoder.json", "encoder.npz"):
        assert filecmp.cmp(tmp_path / name, tmp_path.parent / "before" / name, shallow=False)
    assert tck.load_meta(tmp_path / "encoder")["step"] == 6


def test_reference_checkpoint_served_by_the_port(jax_ckpt):
    """``load_embedder`` of a JAX-trained checkpoint embeds as the
    reference's ``load_embedder`` does."""
    texts = ["lazy dog", "market yolo calls", "", "the quick brown fox jumps"]
    got = load_embedder(jax_ckpt, device=CPU)
    assert isinstance(got, NeuralEmbedder) and got.dim == CFG.dim and got.cfg == CFG
    np.testing.assert_allclose(got(texts), JT.load_embedder(jax_ckpt)(texts), rtol=0, atol=TOL)


def test_trained_embedder_serves_retrieval(tmp_path):
    train_encoder(TEXTS, CFG, steps=4, batch_size=4, seed=4, ckpt_dir=tmp_path, device=CPU)
    emb = load_embedder(tmp_path, device=CPU)
    from openintel_tpu_torch.models.retrievers import HybridRetriever

    r = HybridRetriever.build(TEXTS[:6], embedder=emb, dim=CFG.dim, device=CPU)
    res = r.search(["lazy dog"], k=2)
    assert res.ids.shape == (1, 2) and res.ids[0, 0] in (0, 1)


def test_contrastive_training_generalises_past_lexical_overlap():
    """Queries share a topic with their target docs but no token; the
    trained encoder must beat chance and the untrained one (the
    reference's test, the same data and thresholds)."""
    rng = np.random.default_rng(7)
    n_topics = 4
    qwords = [[f"q{t}_{i}" for i in range(4)] for t in range(n_topics)]
    dwords = [[f"d{t}_{i}" for i in range(12)] for t in range(n_topics)]
    train_docs = []
    for t in range(n_topics):
        for _ in range(16):
            toks = list(rng.choice(dwords[t], size=6, replace=False)) + list(
                rng.choice(qwords[t], size=2, replace=False)
            )
            rng.shuffle(toks)
            train_docs.append(" ".join(toks))
    eval_docs, labels = [], []
    for t in range(n_topics):
        for _ in range(8):
            eval_docs.append(" ".join(rng.choice(dwords[t], size=6, replace=False)))
            labels.append(t)
    labels = np.array(labels)
    queries, q_topics = [], []
    for t in range(n_topics):
        for _ in range(6):
            queries.append(" ".join(rng.choice(qwords[t], size=3, replace=False)))
            q_topics.append(t)
    q_topics = np.array(q_topics)
    cfg = EncoderConfig(vocab_size=512, dim=32, depth=1, heads=2, max_len=16)

    def topic_precision(embedder):
        nn = np.argmax(embedder(queries) @ embedder(eval_docs).T, axis=1)
        return float(np.mean(labels[nn] == q_topics))

    p_before = topic_precision(NeuralEmbedder(cfg, seed=0, device=CPU))
    res = train_encoder(train_docs, cfg, steps=100, batch_size=16, lr=3e-3, seed=0, device=CPU)
    p_after = topic_precision(NeuralEmbedder(cfg, res.params, device=CPU))
    assert p_after > p_before + 0.2, (p_before, p_after)
    assert p_after >= 0.6, (p_before, p_after)


def test_synonym_flip_machinery():
    """flip_tokens: deterministic given an rng, substitutes only mapped
    tokens, flip_p=0 is identity; equal to the reference's draws."""
    docs, syn = synthetic_synonym_corpus(50, n_concepts=20, seed=3)
    assert all(t.startswith("wa") for d in docs for t in d.split())
    assert syn["wa7"] == "wb7"
    rng = np.random.default_rng(0)
    toks = ["wa1", "unknown", "wa2"]
    assert flip_tokens(toks, syn, 0.0, rng) == toks
    assert flip_tokens(toks, syn, 1.0, rng) == ["wb1", "unknown", "wb2"]
    many = [f"wa{i % 20}" for i in range(40)]
    assert flip_tokens(many, syn, 0.5, np.random.default_rng(9)) == jsyn.flip_tokens(
        many, syn, 0.5, np.random.default_rng(9)
    )


@pytest.mark.parametrize("synonyms", [False, True])
def test_make_pairs_matches_the_reference(synonyms):
    docs, syn = synthetic_synonym_corpus(40, n_concepts=12, seed=5)
    kw = {"synonym_map": syn, "flip_p": 0.5} if synonyms else {}
    emb = NeuralEmbedder(CFG, Encoder(CFG), device=CPU)
    jemb = JE.NeuralEmbedder(JCFG, params={})
    got = make_pairs(docs, emb, 8, np.random.default_rng(6), **kw)
    want = JT.make_pairs(docs, jemb, 8, np.random.default_rng(6), **kw)
    for g, w in zip(got, want):
        assert g.dtype == (torch.int32 if w.dtype == np.int32 else torch.bool)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_make_pairs_synonym_substitution():
    """At flip_p=1.0 the queries' ids share none with the documents'."""
    docs, syn = synthetic_synonym_corpus(30, n_concepts=10, seed=5)
    cfg = EncoderConfig(vocab_size=4096, dim=32, depth=1, heads=2, max_len=16)
    emb = NeuralEmbedder(cfg, Encoder(cfg), device=CPU)
    q_ids, q_mask, d_ids, d_mask = make_pairs(docs, emb, 8, np.random.default_rng(6), synonym_map=syn, flip_p=1.0)
    doc_vocab = {int(i) for i in d_ids[d_mask] if i > 0}
    q_vocab = {int(i) for i in q_ids[q_mask] if i > 0}
    assert q_vocab and not (q_vocab & doc_vocab)


def test_template_corpus_composes_phrases():
    docs, phrase_map = synthetic_template_corpus(200, n_concepts=50, seed=3)
    assert len(docs) == 200 and len(phrase_map) == 50
    doc_vocab = {t for d in docs for t in d.split()}
    assert doc_vocab <= set(phrase_map)
    f = int(np.ceil(np.sqrt(50)))
    seen = set()
    for tok, phrase in phrase_map.items():
        parts = phrase.split()
        assert len(parts) == 2 and not (set(parts) & doc_vocab) and phrase not in seen
        seen.add(phrase)
        c = int(tok[2:])
        assert parts == [f"tb{c // f}", f"tc{c % f}"]
    q = " ".join(flip_tokens(["ta7", "ta3"], phrase_map, 1.0, np.random.default_rng(0)))
    assert q == f"{phrase_map['ta7']} {phrase_map['ta3']}" and len(q.split()) == 4
