"""Native (C++) host components of the port, loaded via ctypes.

The port's own copy of the reference package's native layer: the same
``tokenizer.cpp``, ``postings.cpp`` and ``planner.cpp`` and the same C
entry points. :func:`build` compiles them with ``g++`` into
``build/openintel_tpu_torch/`` beside the package (never into the package
directory), naming the library by a hash of the sources, so a library
built from other sources is never loaded. Importing this module installs
the native batch tokenizer into :mod:`openintel_tpu_torch.ops.tokenizer`
when the library for these sources is built; nothing compiles at import.
Python fallbacks keep everything working without the toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from openintel_tpu_torch.utils.profiling import span

_DIR = Path(__file__).parent
_SRCS = [_DIR / "tokenizer.cpp", _DIR / "postings.cpp", _DIR / "planner.cpp"]
BUILD_DIR = _DIR.parents[1] / "build" / "openintel_tpu_torch"

_lib: Optional[ctypes.CDLL] = None

# the planner's phases, in the order of ``plan_build_masked``'s phase array
PHASES = ("dedup_prune", "intersect", "multi_select", "emit", "merge")
# the counts after the phases in that array: the queries that grouped their
# pairwise hits by doc, and the hits they grouped
COUNTS = ("multi_queries", "multi_hits")


def _src_hash() -> str:
    """sha256 over the concatenated .cpp sources."""
    h = hashlib.sha256()
    for s in _SRCS:
        h.update(s.read_bytes())
    return h.hexdigest()


def library_path() -> Path:
    return BUILD_DIR / f"libopenintel_native_{_src_hash()[:16]}.so"


def build() -> Path:
    """Compile the native library (g++ -O3 -march=native -shared -fPIC)
    unless the library for these sources exists. Compiles to a temporary
    name and renames into place, so concurrent builds never load a partial
    file."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC",
         f'-DOPENINTEL_SRC_HASH="{_src_hash()}"']
        + [str(s) for s in _SRCS]
        + ["-o", str(tmp)],
        check=True,
        capture_output=True,
    )
    os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    """The library for these sources, or None when it is not built (never
    compiles: this runs from the import side effect and serving paths)."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        return None
    try:
        lib = _bind(ctypes.CDLL(str(so)))
        if lib.openintel_src_hash().decode("ascii", "replace") != _src_hash():
            return None
    except (AttributeError, OSError):
        return None  # unloadable library: the Python fallbacks take over
    _lib = lib
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tokenize_batch.restype = ctypes.c_int64
    lib.tokenize_batch.argtypes = [
        ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int64, i64p,
    ]
    lib.postings_build.restype = ctypes.c_void_p
    lib.postings_build.argtypes = [ctypes.c_char_p, i64p, ctypes.c_int64]
    lib.postings_n_terms.restype = ctypes.c_int64
    lib.postings_n_terms.argtypes = [ctypes.c_void_p]
    lib.postings_nnz.restype = ctypes.c_int64
    lib.postings_nnz.argtypes = [ctypes.c_void_p]
    lib.postings_vocab_bytes.restype = ctypes.c_int64
    lib.postings_vocab_bytes.argtypes = [ctypes.c_void_p]
    lib.postings_export.restype = None
    lib.postings_export.argtypes = [
        ctypes.c_void_p, i64p, i32p, f32p, f32p, i32p, ctypes.c_char_p, i64p,
    ]
    lib.postings_free.restype = None
    lib.postings_free.argtypes = [ctypes.c_void_p]
    lib.plan_build_masked.restype = ctypes.c_int64
    lib.plan_build_masked.argtypes = [
        i64p, i32p, f32p, i64p, f32p, ctypes.c_int64,
        i32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        i64p, i32p, f32p,  # pruned cache (nullable): offsets, doc_ids, impacts
        i32p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,  # bitmap cache
        i32p, f32p, ctypes.c_int64, i64p, ctypes.c_int64,
        i64p,  # the phase totals and counts (nullable; PHASES + COUNTS)
    ]
    lib.openintel_src_hash.restype = ctypes.c_char_p
    lib.openintel_src_hash.argtypes = []
    return lib


def native_build_postings(texts: Sequence[str]):
    """Tokenize->vocab->CSR in C++; returns raw arrays or None if unavailable
    or the corpus is not pure ASCII (the Python builder handles those).

    Returns (term_offsets, doc_ids, tf, doc_len, df, vocab_dict)."""
    lib = _load()
    if lib is None:
        return None
    try:
        joined = "".join(texts).encode("ascii")
    except UnicodeEncodeError:
        return None
    n = len(texts)
    offs = np.zeros(n + 1, dtype=np.int64)
    # every text is pure ASCII (the joined encode proved it): char length
    # == byte length
    np.cumsum([len(t) for t in texts], out=offs[1:])
    handle = lib.postings_build(
        joined, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n
    )
    try:
        n_terms = lib.postings_n_terms(handle)  # includes pad slot 0
        nnz = lib.postings_nnz(handle)
        vb = lib.postings_vocab_bytes(handle)
        term_offsets = np.zeros(n_terms + 1, dtype=np.int64)
        doc_ids = np.zeros(max(nnz, 1), dtype=np.int32)
        tf = np.zeros(max(nnz, 1), dtype=np.float32)
        doc_len = np.zeros(max(n, 1), dtype=np.float32)
        df = np.zeros(n_terms, dtype=np.int32)
        vocab_buf = ctypes.create_string_buffer(max(int(vb), 1))
        vocab_offs = np.zeros(n_terms + 1, dtype=np.int64)
        lib.postings_export(
            handle,
            term_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            doc_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            doc_len.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            df.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            vocab_buf,
            vocab_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    finally:
        lib.postings_free(handle)
    raw = vocab_buf.raw
    vocab = {
        raw[vocab_offs[t] : vocab_offs[t + 1]].decode("ascii"): t
        for t in range(1, n_terms)
    }
    return term_offsets, doc_ids[:nnz], tf[:nnz], doc_len[:n], df, vocab


def native_tokenize_batch(texts: Sequence[str]) -> Optional[list[list[str]]]:
    """Batch tokenise via the C++ library; None if unavailable. Non-ASCII
    documents go to the Python tokenizer (the two agree on ASCII only)."""
    lib = _load()
    if lib is None:
        return None
    from openintel_tpu_torch.ops.tokenizer import tokenize as py_tokenize

    encoded: list[Optional[bytes]] = []
    for t in texts:
        try:
            encoded.append(t.encode("ascii"))
        except UnicodeEncodeError:
            encoded.append(None)  # python fallback per document
    out: list[list[str]] = [
        py_tokenize(t) if b is None else [] for t, b in zip(texts, encoded)
    ]
    ascii_idx = [i for i, b in enumerate(encoded) if b is not None]
    if ascii_idx:
        bufs = [encoded[i] for i in ascii_idx]
        joined = b"".join(bufs)  # type: ignore[arg-type]
        n = len(bufs)
        offs = (ctypes.c_int64 * (n + 1))()
        pos = 0
        for j, b in enumerate(bufs):
            offs[j] = pos
            pos += len(b)  # type: ignore[arg-type]
        offs[n] = pos
        out_buf = ctypes.create_string_buffer(max(pos, 1))
        out_offs = (ctypes.c_int64 * (n + 1))()
        written = lib.tokenize_batch(
            joined, offs, n, out_buf, max(pos, 1), out_offs
        )
        if written < 0:  # pragma: no cover - the cap is provably sufficient
            raise RuntimeError("native tokenizer output buffer overflow")
        raw = out_buf.raw
        for j, i in enumerate(ascii_idx):
            chunk = raw[out_offs[j] : out_offs[j + 1]].decode("ascii")
            out[i] = chunk.split(" ") if chunk else []
    return out


def native_build_query_plan(
    index,
    queries_term_ids: Sequence[Sequence[int]],
    max_postings_per_term: int,
    multi_budget: int,
    n_threads: int = 0,  # 0 = hardware concurrency
    doc_mask=None,  # (n_docs,) bool: filtered plans (planner.cpp)
    bitmap_min_df: Optional[int] = None,  # df threshold override (tests)
):
    """C++ pruned-plan assembly (see planner.cpp); returns (doc_ids (B, W)
    int32 sentinel-padded, weights (B, W) f32, max_terms, max_width) or
    None when the library is unavailable. Candidate sets are identical to
    the NumPy path of ``ops.bm25.build_query_plan``, including under
    ``doc_mask``."""
    lib = _load()
    if lib is None:
        return None
    order = index.ensure_impact_order()
    b = len(queries_term_ids)
    t_max = max((len(t) for t in queries_term_ids), default=1) or 1
    q = np.zeros((b, t_max), dtype=np.int32)
    max_terms = 1
    for i, terms in enumerate(queries_term_ids):
        clean = [t for t in terms if t > 0]
        q[i, : len(clean)] = clean
        max_terms = max(max_terms, len(set(clean)))

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    term_offsets = np.ascontiguousarray(index.term_offsets, dtype=np.int64)
    doc_ids = np.ascontiguousarray(index.doc_ids, dtype=np.int32)
    impact = np.ascontiguousarray(index.impact, dtype=np.float32)
    order = np.ascontiguousarray(order, dtype=np.int64)
    idf = np.ascontiguousarray(index.idf, dtype=np.float32)
    n_terms_vocab = term_offsets.shape[0] - 1

    mask_u8 = None
    if doc_mask is not None:
        mask_u8 = np.ascontiguousarray(doc_mask, dtype=np.uint8)
        if mask_u8.shape != (index.n_docs,):
            # the C side indexes doc_mask[d] for d < n_docs: a short buffer
            # would be an out-of-bounds read, not a Python error
            raise ValueError(
                f"doc_mask shape {mask_u8.shape} != ({index.n_docs},)"
            )
    # the doc-sorted top-M cache (index.pruned_cache) for batches big enough
    # to amortise building it; filtered plans cannot use it
    p_offs = p_doc = p_imp = None
    cached = getattr(index, "_pruned_cache", None)
    if doc_mask is None and (
        b >= 32 or (cached is not None and max_postings_per_term in cached)
    ):
        p_offs, p_doc, p_imp = index.pruned_cache(max_postings_per_term)
        p_offs = np.ascontiguousarray(p_offs, dtype=np.int64)

    # postings membership bitmaps for high-df terms (index.bitmap_cache)
    bm_slots = bm_words = None
    bm_stride = 0
    bm_cached = getattr(index, "_bitmap_cache", None)
    forced = bitmap_min_df is not None
    if not forced:
        bitmap_min_df = max(8192, index.n_docs // 256)
    if forced or b >= 32 or (
        bm_cached is not None and bitmap_min_df in bm_cached
    ):
        bm_slots, bm_words = index.bitmap_cache(bitmap_min_df)
        if bm_words is not None:
            bm_stride = bm_words.shape[1]

    cap = int(t_max * (max_postings_per_term + multi_budget))
    threads = min(n_threads if n_threads > 0 else (os.cpu_count() or 1), max(b, 1))
    while True:
        out_ids = np.full((b, cap), index.n_docs, dtype=np.int32)
        out_w = np.zeros((b, cap), dtype=np.float32)
        widths = np.zeros(b, dtype=np.int64)
        phase_ns = np.zeros(len(PHASES) + len(COUNTS), dtype=np.int64)
        with span("planner", n=b, threads=threads) as sp:
            rc = lib.plan_build_masked(
                term_offsets.ctypes.data_as(i64p),
                doc_ids.ctypes.data_as(i32p),
                impact.ctypes.data_as(f32p),
                order.ctypes.data_as(i64p),
                idf.ctypes.data_as(f32p),
                n_terms_vocab,
                q.ctypes.data_as(i32p),
                b,
                t_max,
                max_postings_per_term,
                multi_budget,
                mask_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                if mask_u8 is not None else None,
                p_offs.ctypes.data_as(i64p) if p_offs is not None else None,
                p_doc.ctypes.data_as(i32p) if p_doc is not None else None,
                p_imp.ctypes.data_as(f32p) if p_imp is not None else None,
                bm_slots.ctypes.data_as(i32p) if bm_slots is not None else None,
                bm_words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
                if bm_words is not None else None,
                bm_stride,
                out_ids.ctypes.data_as(i32p),
                out_w.ctypes.data_as(f32p),
                cap,
                widths.ctypes.data_as(i64p),
                n_threads,
                phase_ns.ctypes.data_as(i64p),
            )
            sp.attrs.update(zip(PHASES + COUNTS, phase_ns.tolist()))
        if rc >= 0:
            return out_ids, out_w, max_terms, int(rc)  # rc = exact max width
        cap = int(-rc)  # grow to the reported required width and retry


def install() -> bool:
    """Wire the native tokenizer into the port's ops.tokenizer; True if
    active."""
    if _load() is None:
        return False
    from openintel_tpu_torch.ops import tokenizer as tok

    tok._native_tokenize_batch = native_tokenize_batch
    return True


# Import side effect: wire the native batch tokenizer whenever the library
# for these sources is already built. No compilation happens here.
install()
