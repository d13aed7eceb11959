"""The inputs of a cell, made from ``--seed``: postings, stored rows, a pool
of queries and the filter masks.

Postings follow the statistics of the program's synthetic bench index
(``index/synthetic.py``, ``synthetic_postings_index``), made on the device
in a few large calls: term ranks Zipf(s) over the vocabulary, each term
present in a doc with probability min(1, p * mean_len) (df drawn by one
binomial per term), doc ids drawn with replacement and deduplicated,
geometric tf, lognormal doc lengths. Rows are unit float32 normals rounded
to the store's dtype. Queries take ``terms`` ids (a count uniform over
the configuration's range) log-uniform over the ranks ``rank_min`` ..
vocab - 1 (term id = rank + 1, token ``t<rank>``),
and an embedding near a random stored row: row + noise * N(0, I),
normalised (the program's ``bench.py`` queries).

Every seed gets the same sizes: the number of terms per query is a fixed
multiset, the term ranks are stratified over the log-uniform range, and
only their order and pairing depend on the seed.

A live corpus's write pool is made with the corpus, as more docs of the
same statistics after the base segment's; a pooled doc reaches the program
as text (:func:`live_pool`), so its length is its token count, the sum of
its tf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

STORE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
ROW_CHUNK = 1 << 16  # rows a generation step: its float32 transient stays near 100 MB

# one stream of randomness per purpose, so that adding one leaves the rest
STREAM = {"postings": 1, "rows": 2, "queries": 3, "masks": 4, "order": 5, "sample": 6}


def rng(seed: int, purpose: str, *extra: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2**64 - 1), STREAM[purpose], *extra])


def torch_gen(seed: int, purpose: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, purpose).integers(0, 2**63 - 1)))
    return g


@dataclass
class Postings:
    """Raw CSR postings: term id t (1 .. V) spans [offsets[t], offsets[t + 1]);
    slot 0 is the padding term. Host arrays for the program's index, device
    tensors for the reference."""

    offsets: np.ndarray  # (V + 2,) int64
    doc_ids: np.ndarray  # (nnz,) int32, ascending within a term
    tf: np.ndarray  # (nnz,) f32
    doc_len: np.ndarray  # (N,) f32
    doc_ids_dev: torch.Tensor
    tf_dev: torch.Tensor
    doc_len_dev: torch.Tensor


def make_postings(n_docs: int, vocab: int, spec: dict, seed: int, device) -> Postings:
    r = rng(seed, "postings")
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** -float(spec["zipf_s"])
    probs /= probs.sum()
    df = r.binomial(n_docs, np.minimum(1.0, probs * spec["mean_len"])).astype(np.int64)
    g = torch_gen(seed, "postings", device)
    term_of = torch.repeat_interleave(
        torch.arange(vocab, device=device), torch.from_numpy(df).to(device)
    )
    draws = torch.randint(0, n_docs, (term_of.shape[0],), generator=g, device=device)
    keys = torch.unique(term_of * n_docs + draws)  # sorted: term-major, docs ascending
    del term_of, draws
    term = keys // n_docs
    doc_ids = (keys - term * n_docs).to(torch.int32)
    counts = torch.bincount(term, minlength=vocab).cpu().numpy()
    del keys, term
    offsets = np.zeros(vocab + 2, np.int64)
    offsets[2:] = np.cumsum(counts)
    tf = torch.empty(doc_ids.shape[0], device=device).geometric_(spec["tf_p"], generator=g)
    sigma = float(spec["len_sigma"])
    doc_len = torch.empty(n_docs, device=device).log_normal_(
        math.log(spec["mean_len"]) - sigma**2 / 2, sigma, generator=g
    ).clamp_(min=3.0)
    return Postings(
        offsets=offsets, doc_ids=doc_ids.cpu().numpy(), tf=tf.cpu().numpy(),
        doc_len=doc_len.cpu().numpy(), doc_ids_dev=doc_ids, tf_dev=tf, doc_len_dev=doc_len,
    )


def make_rows(n_docs: int, dim: int, store: str, seed: int, device) -> torch.Tensor:
    """(N, D) unit rows in the store's dtype, made on the device."""
    g = torch_gen(seed, "rows", device)
    out = torch.empty((n_docs, dim), dtype=STORE_DTYPES[store], device=device)
    for s in range(0, n_docs, ROW_CHUNK):
        x = torch.randn((min(ROW_CHUNK, n_docs - s), dim), generator=g, device=device)
        out[s : s + x.shape[0]] = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return out


@dataclass
class QueryPool:
    texts: list  # query strings, distinct
    term_ids: list  # per query, the term ids (rank + 1) in order
    emb: np.ndarray  # (P, D) f32 unit query embeddings
    groups: Optional[np.ndarray] = None  # (P,) int32 filter mask row per query

    def __len__(self) -> int:
        return len(self.texts)


def make_queries(rows: torch.Tensor, vocab: int, pool: int, model: dict, seed: int) -> QueryPool:
    r = rng(seed, "queries")
    lo, hi = model["terms"]
    n_terms = np.resize(np.arange(lo, hi + 1), pool)
    r.shuffle(n_terms)
    total = int(n_terms.sum())
    u = (np.arange(total) + r.random(total)) / total
    a, b = math.log(model["rank_min"]), math.log(vocab - 1)
    ranks = np.minimum(np.exp(a + u * (b - a)).astype(np.int64), vocab - 1)
    r.shuffle(ranks)
    texts, term_ids, seen = [], [], set()
    for q in np.split(ranks, np.cumsum(n_terms)[:-1]):
        text = " ".join(f"t{x}" for x in q)
        if text in seen:  # the lookup embedder needs one embedding per string
            continue
        seen.add(text)
        texts.append(text)
        term_ids.append([int(x) + 1 for x in q])
    n_docs, dim = rows.shape
    targets = torch.from_numpy(r.integers(0, n_docs, len(texts))).to(rows.device)
    g = torch_gen(seed, "queries", rows.device)
    noise = torch.randn((len(texts), dim), generator=g, device=rows.device)
    q = rows[targets].float() + float(model["noise"]) * noise
    q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return QueryPool(texts=texts, term_ids=term_ids, emb=q.cpu().numpy())


def make_masks(n_docs: int, shares: list, seed: int, device) -> np.ndarray:
    """(G, N) bool doc masks: ``count`` masks keeping each ``share`` of the
    docs, for every [share, count] pair."""
    g = torch_gen(seed, "masks", device)
    out = []
    for share, count in shares:
        for _ in range(int(count)):
            out.append((torch.rand(n_docs, generator=g, device=device) < share).cpu().numpy())
    return np.stack(out)


def pooled_lengths(p: Postings, n_base: int) -> None:
    """Set the length of every doc from ``n_base`` on to its token count,
    the sum of its tf: the length the program measures of its text."""
    n = p.doc_len_dev.shape[0]
    tokens = torch.zeros(n, device=p.doc_len_dev.device).index_add_(0, p.doc_ids_dev.long(), p.tf_dev)
    p.doc_len_dev[n_base:] = tokens[n_base:]
    p.doc_len = p.doc_len_dev.cpu().numpy()


@dataclass
class LivePool:
    base: Postings  # the first n_base docs' postings (tensors on the host)
    texts: list  # each pooled doc's text: the token t<rank> of each term, tf times
    rows: np.ndarray  # (n_pool, D) float32 pooled rows, the stored values


def live_pool(p: Postings, rows: torch.Tensor, n_base: int) -> LivePool:
    """The base segment's postings and, for each pooled doc (``n_base`` on),
    what ``add_documents`` takes: its text and its row."""
    term = np.repeat(np.arange(p.offsets.shape[0] - 1), np.diff(p.offsets))
    keep = p.doc_ids < n_base
    offsets = np.zeros_like(p.offsets)
    offsets[1:] = np.cumsum(np.bincount(term[keep], minlength=p.offsets.shape[0] - 1))
    doc_ids, tf = p.doc_ids[keep], p.tf[keep]
    doc_len = p.doc_len[:n_base]
    base = Postings(offsets=offsets, doc_ids=doc_ids, tf=tf, doc_len=doc_len,
                    doc_ids_dev=torch.from_numpy(doc_ids), tf_dev=torch.from_numpy(tf),
                    doc_len_dev=torch.from_numpy(doc_len))
    pooled = np.flatnonzero(~keep)
    pooled = pooled[np.argsort(p.doc_ids[pooled], kind="stable")]  # doc-major, terms ascending
    n_pool = rows.shape[0] - n_base
    tokens = np.repeat(np.array([f"t{t - 1}" for t in term[pooled]], dtype=object),
                       p.tf[pooled].astype(np.int64))
    ends = np.cumsum(np.bincount(np.repeat(p.doc_ids[pooled] - n_base, p.tf[pooled].astype(np.int64)),
                                 minlength=n_pool))
    texts = [" ".join(part) for part in np.split(tokens, ends[:-1])]
    return LivePool(base=base, texts=texts, rows=rows[n_base:].float().cpu().numpy())


class PoolEmbedder:
    """The program's query embedder for this benchmark: each query string
    of the pool maps to its generated embedding (a deployment runs an
    encoder here; the benchmark hands the encoder's output as input)."""

    def __init__(self, pool: QueryPool):
        self.dim = pool.emb.shape[1]
        self._emb = pool.emb
        self._row = {t: i for i, t in enumerate(pool.texts)}

    def __call__(self, texts) -> np.ndarray:
        return self._emb[[self._row[t] for t in texts]]


class Order:
    """The order in which a closed loop takes the pool: pass after pass,
    each pass a permutation drawn from the seed."""

    def __init__(self, n: int, seed: int):
        self.n, self.seed = n, seed
        self._perm: dict[int, np.ndarray] = {}

    def take(self, start: int, count: int) -> np.ndarray:
        out = []
        while count:
            p, off = divmod(start, self.n)
            perm = self._perm.get(p)
            if perm is None:
                perm = self._perm[p] = rng(self.seed, "order", p).permutation(self.n)
                self._perm.pop(p - 2, None)
            got = perm[off : off + count]
            out.append(got)
            start += len(got)
            count -= len(got)
        return np.concatenate(out)
