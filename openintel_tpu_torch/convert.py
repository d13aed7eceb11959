"""Carry index state across to the port's classes and tensors.

An index built by the JAX package comes across by its arrays alone:
:func:`postings_index` and :func:`dense_index_from` read its attributes and
give the port's own ``PostingsIndex`` and ``DenseIndex``
(:mod:`openintel_tpu_torch.index.schema`), without importing the JAX
package. A ``DenseIndex``'s rows (float32, or bfloat16: a torch tensor, or
``ml_dtypes`` bf16 as the JAX package stores them) become the port's device
tensors:

- the stored rows (f32, or bf16 read through a 16-bit view, so no
  ``ml_dtypes`` is needed);
- the candidate corpora, made once at load from the stored rows
  (bf16-rounded values where the store is bf16, as the reference does) and
  zero-padded to a multiple of 16,384 docs and their feature axis to a
  multiple of 16 columns (:func:`pad_features`, exact: zero columns add
  nothing to a dot): kernel A's int8 rows
  (:func:`int8_corpus`), kernel D's f32/bf16 rows (:func:`fast_corpus`)
  and kernel E's nibble-packed int4 rows (:func:`int4_corpus`), all
  row-major;
- the rescore rows, which are the stored rows.
"""

from __future__ import annotations

import numpy as np
import torch

from openintel_tpu_torch.index.schema import (
    BM25Config,
    DenseIndex,
    PostingsIndex,
)
from openintel_tpu_torch.ops.dense_topk import (
    _TURBO_UNIT,
    _pack_pairs,
    _round_up,
    pad_corpus_rows,
    pad_features,
    padded_dim,
    quantize_int4,
    quantize_int8,
)
from openintel_tpu_torch.ops.tokenizer import Vocab


def stored_rows(index: DenseIndex, device) -> torch.Tensor:
    """The index's stored rows as a (N, D) f32 or bf16 tensor on ``device``.
    Accepts embeddings held as a numpy array (f32 or ``ml_dtypes`` bf16) or
    as a torch tensor (f32 or bf16)."""
    emb = index.embeddings
    if isinstance(emb, torch.Tensor):
        rows = emb
    else:
        arr = np.ascontiguousarray(emb)
        if arr.dtype == np.float32:
            rows = torch.from_numpy(arr)
        elif arr.dtype.name == "bfloat16":
            rows = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            raise TypeError(f"dense rows must be f32 or bf16, got {arr.dtype}")
    if rows.dtype not in (torch.float32, torch.bfloat16) or rows.ndim != 2:
        raise TypeError(f"dense rows must be 2-D f32 or bf16, got {rows.dtype}")
    return rows.to(device).contiguous()


def int8_corpus(rows: torch.Tensor, chunk: int = 1 << 16) -> torch.Tensor:
    """Kernel A's candidate corpus: ``quantize_int8`` of the stored rows,
    (N_pad, D_pad) int8 with zero rows up to a multiple of 16,384 and zero
    columns up to a multiple of 16. Quantises in chunks on the rows'
    device, so no full f32 copy is ever held."""
    n, dim = rows.shape
    n_pad = _round_up(max(n, _TURBO_UNIT), _TURBO_UNIT)
    out = torch.zeros((n_pad, padded_dim(dim)), dtype=torch.int8, device=rows.device)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        out[start:stop, :dim] = quantize_int8(rows[start:stop])
    return out


def fast_corpus(rows: torch.Tensor) -> torch.Tensor:
    """Kernel D's candidate corpus: the stored (N, D) f32/bf16 rows with zero
    rows up to a multiple of 16,384 and zero columns up to a multiple of
    16, on the rows' device (the row-major form of the reference's padded
    transposed operand); the rows themselves when they fit already."""
    return pad_corpus_rows(rows, padded_dim(rows.shape[1]))


def fused_corpus(rows: torch.Tensor) -> torch.Tensor:
    """Kernel B's rows: the stored (N, D) rows with zero columns up to a
    multiple of 16 (not padded in N: kernel B masks its last doc tile)."""
    return pad_features(rows).contiguous()


def int4_corpus(rows: torch.Tensor, chunk: int = 1 << 16) -> torch.Tensor:
    """Kernels E's candidate corpus: ``quantize_int4`` of the stored rows,
    zero-padded to a multiple of 16,384 docs (and 16 columns) and packed
    two docs per byte, (N_pad / 2, D_pad) int8 (``pack_corpus_i4``).
    Quantises in chunks of an even number of rows on the rows' device."""
    n, dim = rows.shape
    n_pad = _round_up(max(n, _TURBO_UNIT), _TURBO_UNIT)
    chunk += chunk % 2  # whole doc pairs
    out = torch.zeros((n_pad // 2, padded_dim(dim)), dtype=torch.int8, device=rows.device)
    for start in range(0, n, chunk):
        x4 = quantize_int4(rows[start : start + chunk])
        if x4.shape[0] % 2:  # the last doc pairs with a zero row
            x4 = torch.cat([x4, x4.new_zeros((1, dim))])
        out[start // 2 : (start + x4.shape[0]) // 2, :dim] = _pack_pairs(x4)
    return out


def postings_index(src) -> PostingsIndex:
    """The port's ``PostingsIndex`` holding the arrays of ``src``, a
    postings index built elsewhere (the JAX package's, or the port's own):
    the same numpy arrays, vocabulary and BM25 constants, read by
    attribute."""
    return PostingsIndex(
        term_offsets=src.term_offsets,
        doc_ids=src.doc_ids,
        tf=src.tf,
        impact=src.impact,
        df=src.df,
        idf=src.idf,
        doc_len=src.doc_len,
        avgdl=float(src.avgdl),
        n_docs=int(src.n_docs),
        vocab=Vocab(token_to_id=dict(src.vocab.token_to_id)),
        config=BM25Config(k1=src.config.k1, b=src.config.b),
        impact_order=src.impact_order,
    )


def dense_index_from(src) -> DenseIndex:
    """The port's ``DenseIndex`` holding the rows of ``src``, a dense index
    built elsewhere: the same rows (``ml_dtypes`` bf16 stays as it is, read
    through a 16-bit view by :func:`stored_rows`), read by attribute."""
    return DenseIndex(
        embeddings=src.embeddings, n_docs=int(src.n_docs), dim=int(src.dim)
    )
