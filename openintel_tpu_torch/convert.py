"""Carry the reference package's index state across to the port's tensors.

``PostingsIndex`` stays on the host as it is (the planner reads it).
``DenseIndex.embeddings`` (float32, or ``ml_dtypes`` bfloat16 as the JAX
package stores it) becomes the port's device tensors:

- the stored rows (f32, or bf16 read through a 16-bit view, so no
  ``ml_dtypes`` is needed);
- the candidate corpora, made once at load from the stored rows
  (bf16-rounded values where the store is bf16, as the reference does) and
  zero-padded to a multiple of 16,384 docs: kernel A's int8 rows
  (:func:`int8_corpus`), kernel D's f32/bf16 rows (:func:`fast_corpus`)
  and kernel E's nibble-packed int4 rows (:func:`int4_corpus`), all
  row-major;
- the rescore rows, which are the stored rows.

:func:`dense_index` is the port's ``DenseIndex.from_embeddings``: it makes
bf16 rows with torch (round to nearest even, as ``ml_dtypes``) and holds
them in a ``DenseIndex`` as a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from openintel_tpu.index.schema import DenseIndex
from openintel_tpu_torch.ops.dense_topk import (
    _TURBO_UNIT,
    _pack_pairs,
    _round_up,
    pad_corpus_rows,
    quantize_int4,
    quantize_int8,
)


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
    (N_pad, D) int8 with zero rows up to a multiple of 16,384. Quantises
    in chunks on the rows' device, so no full f32 copy is ever held."""
    n, dim = rows.shape
    n_pad = _round_up(max(n, _TURBO_UNIT), _TURBO_UNIT)
    out = torch.zeros((n_pad, dim), dtype=torch.int8, device=rows.device)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        out[start:stop] = quantize_int8(rows[start:stop])
    return out


# Kernel D's candidate corpus: the stored (N, D) f32/bf16 rows with zero rows
# up to a multiple of 16,384, on the rows' device (the row-major form of the
# reference's padded transposed operand).
fast_corpus = pad_corpus_rows


def int4_corpus(rows: torch.Tensor, chunk: int = 1 << 16) -> torch.Tensor:
    """Kernels E's candidate corpus: ``quantize_int4`` of the stored rows,
    zero-padded to a multiple of 16,384 docs and packed two docs per byte,
    (N_pad / 2, D) int8 (``pack_corpus_i4``). Quantises in chunks of an
    even number of rows on the rows' device."""
    n, dim = rows.shape
    n_pad = _round_up(max(n, _TURBO_UNIT), _TURBO_UNIT)
    chunk += chunk % 2  # whole doc pairs
    out = torch.zeros((n_pad // 2, dim), dtype=torch.int8, device=rows.device)
    for start in range(0, n, chunk):
        x4 = quantize_int4(rows[start : start + chunk])
        if x4.shape[0] % 2:  # the last doc pairs with a zero row
            x4 = torch.cat([x4, x4.new_zeros((1, dim))])
        out[start // 2 : (start + x4.shape[0]) // 2] = _pack_pairs(x4)
    return out


def dense_index(raw: np.ndarray, *, dtype=torch.float32) -> DenseIndex:
    """``DenseIndex.from_embeddings`` for the port: the reference's float32
    normalisation, rows stored as a CPU tensor of ``dtype`` (torch.float32
    or torch.bfloat16)."""
    f32 = DenseIndex.from_embeddings(raw)
    rows = torch.from_numpy(f32.embeddings).to(dtype)
    return DenseIndex(embeddings=rows, n_docs=f32.n_docs, dim=f32.dim)
