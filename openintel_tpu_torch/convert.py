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

A trained encoder comes across by its params tree: :func:`encoder_params`
gives the port's ``Encoder`` from the JAX package's tree of arrays, and
:func:`encoder_tree` gives that tree back. The heads on the trunk come
across the same way: :func:`head_params`/:func:`head_tree` for a head
``{"w", "b"}`` (the analyzer's (dim, 2), the reranker's (dim, 1)), and
:func:`reranker_params`/:func:`reranker_tree` for a reranker's whole
tree ``{"params", "head": {"w", "b"}}``.
"""

from __future__ import annotations

import numpy as np
import torch

from openintel_tpu_torch.index.schema import (
    BM25Config,
    DenseIndex,
    PostingsIndex,
)
from openintel_tpu_torch.models.encoder import Encoder, load_param_tree, param_tree
from openintel_tpu_torch.ops.dense_topk import (
    _I4_SCALE_DEFAULT,
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
        arr = np.asarray(emb)
        if arr.dtype.name == "bfloat16":
            arr = arr.view(np.int16)
        elif arr.dtype != np.float32:
            raise TypeError(f"dense rows must be f32 or bf16, got {arr.dtype}")
        if not arr.flags.writeable or not arr.flags.c_contiguous:
            # a read-only memory map (``checkpoint.load_dense``): copied
            # once, a chunk at a time, into a tensor on the device
            return _copied_rows(arr, arr.dtype == np.int16, device)
        rows = torch.from_numpy(arr)
        if arr.dtype == np.int16:
            rows = rows.view(torch.bfloat16)
    if rows.dtype not in (torch.float32, torch.bfloat16) or rows.ndim != 2:
        raise TypeError(f"dense rows must be 2-D f32 or bf16, got {rows.dtype}")
    return rows.to(device).contiguous()


def _copied_rows(arr: np.ndarray, bf16: bool, device, chunk: int = 1 << 16) -> torch.Tensor:
    """``arr`` (f32, or with ``bf16`` the words as int16) copied into a new
    (N, D) tensor on ``device``, ``chunk`` rows at a time, so the host
    holds one chunk's copy at most."""
    if arr.ndim != 2:
        raise TypeError(f"dense rows must be 2-D, got shape {arr.shape}")
    out = torch.empty(arr.shape, dtype=torch.bfloat16 if bf16 else torch.float32, device=device)
    for start in range(0, arr.shape[0], chunk):
        part = torch.from_numpy(np.array(arr[start : start + chunk]))
        out[start : start + chunk] = part.view(torch.bfloat16) if bf16 else part
    return out


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


def int4_corpus(rows: torch.Tensor, chunk: int = 1 << 16, *, scale: float = _I4_SCALE_DEFAULT) -> torch.Tensor:
    """Kernels E's candidate corpus: ``quantize_int4`` of the stored rows at
    ``scale`` (the served 32 by default), zero-padded to a multiple of
    16,384 docs (and 16 columns) and packed two docs per byte, (N_pad / 2,
    D_pad) int8 (``pack_corpus_i4``). Quantises in chunks of an even number
    of rows on the rows' device."""
    n, dim = rows.shape
    n_pad = _round_up(max(n, _TURBO_UNIT), _TURBO_UNIT)
    chunk += chunk % 2  # whole doc pairs
    out = torch.zeros((n_pad // 2, padded_dim(dim)), dtype=torch.int8, device=rows.device)
    for start in range(0, n, chunk):
        x4 = quantize_int4(rows[start : start + chunk], scale)
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


def encoder_params(tree, cfg, device=None):
    """The JAX package's encoder params (a tree of arrays in its layout:
    ``tok_emb``, ``pos_emb``, ``blocks``, ``ln_f``) as the port's
    ``Encoder`` of config ``cfg`` on ``device``."""
    model = load_param_tree(Encoder(cfg), tree)
    return model.to(device) if device is not None else model


def encoder_tree(model) -> dict:
    """The inverse of :func:`encoder_params`: ``model``'s weights as the
    JAX package's params tree of numpy float32 arrays."""
    return param_tree(model, lambda p: p.detach().cpu().numpy())


def head_params(tree, device=None) -> dict:
    """A head of the JAX package (``{"w", "b"}`` arrays: the analyzer's or
    the reranker's) as f32 tensors on ``device``."""
    return {
        name: torch.from_numpy(np.array(tree[name], np.float32)).to(device)
        for name in ("w", "b")
    }


def head_tree(head: dict) -> dict:
    """The inverse of :func:`head_params`: numpy float32 arrays."""
    return {name: head[name].detach().cpu().numpy() for name in ("w", "b")}


def reranker_params(tree, cfg, device=None):
    """A reranker's tree of the JAX package (``{"params", "head": {"w",
    "b"}}``) as the port's (``Encoder``, head) on ``device``."""
    return encoder_params(tree["params"], cfg, device), head_params(tree["head"], device)


def reranker_tree(model, head: dict) -> dict:
    """The inverse of :func:`reranker_params`."""
    return {"params": encoder_tree(model), "head": head_tree(head)}
