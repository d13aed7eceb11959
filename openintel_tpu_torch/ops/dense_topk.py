"""Dense candidate kernels for Hopper and their plain PyTorch twins.

Counterparts of :mod:`openintel_tpu.ops.pallas.dense_topk`:

- kernel A, ``csrc/i8_top2g.cu`` (replaces ``_turbo_kernel_i8_top2g``):
  the int8 candidate pass of :func:`dense_topk_fast_i8_grouped`, the
  default dense arm at 100k docs and more;
- kernel B, ``csrc/fused_topk.cu`` (replaces ``_kernel`` of
  ``dense_topk_pallas``): the exact fused cosine top-k of
  :func:`dense_topk_pallas`, the dense arm of smaller corpora;
- :func:`exact_rescore`, :func:`quantize_int8`, :func:`auto_i8_group` and
  the int8 key constants, as torch ops.

Each kernel has a wrapper (:func:`i8_top2g_cells`, :func:`fused_topk`) and a
plain twin of the same function (``*_plain``). A wrapper given CPU tensors
runs the twin; given CUDA tensors it launches the kernel or raises. Each
wrapper counts its launches in its ``launches`` attribute.

Layout: the int8 candidate corpus is row-major ``(N_pad, D)``, zero-padded
to a multiple of 16,384 rows once at load (the JAX package streams the
transposed ``(D, N_pad)`` copy its TPU kernel wants). The candidate cells
are integer-exact, so the port's candidate ids equal the reference's bit
for bit.
"""

from __future__ import annotations

import torch

from openintel_tpu_torch.ops import _kernels
from openintel_tpu_torch.ops.dense import dense_topk_xla, require_true_f32
from openintel_tpu_torch.ops.ranking import sort_by_score_then_id, stable_topk

NEG_INF = float("-inf")
_I8_BIAS = 32768  # int dot in (-32768, 32767) -> strictly positive
_I8_FLAG128 = (_I8_BIAS + (1 << 23)) * 128  # bias + the reference's float flag, <<7
_I8_SCALE = 127.0 * 127.0  # int dot -> cosine
_SUPER = 128  # sub-blocks (of 128 docs) per super
_TURBO_UNIT = _SUPER * 128  # docs per super (16,384)
_I8_QUERY_TILE = 32  # queries per kernel-A block; batches pad to it
_FUSED_MAX_K = 1024  # the reference kernel's k <= block_c bound
_SMEM_LIMIT = 232_448  # dynamic shared memory one H100 block may use


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def quantize_int8(emb: torch.Tensor) -> torch.Tensor:
    """round(127 * x) for unit-norm embeddings, clipped to [-127, 127]
    (round half to even, as ``np.rint``)."""
    x = emb.float()
    return torch.clamp(torch.round(127.0 * x), -127, 127).to(torch.int8)


def pad_corpus_i8(corpus: torch.Tensor) -> torch.Tensor:
    """Zero-pad an (N, D) int8 corpus to a multiple of 16,384 rows (at
    least one super). Done once at index load: the hot path must never
    copy the corpus."""
    n, dim = corpus.shape
    n_pad = _round_up(max(n, _TURBO_UNIT), _TURBO_UNIT)
    if n_pad == n:
        return corpus
    out = torch.zeros((n_pad, dim), dtype=torch.int8, device=corpus.device)
    out[:n] = corpus
    return out


def auto_i8_group(n_docs: int, c: int) -> int:
    """Group size for :func:`dense_topk_fast_i8_grouped`: hold the number of
    candidate groups (ng) at max(8, ceil(c / 64)), so the exact top-k
    width (2 * ng * 128) and the per-cell collision odds stay constant as
    the corpus grows. Part of the semantics: it decides which candidates
    survive."""
    n_super = -(-max(n_docs, 1) // _TURBO_UNIT)
    ng = max(8, -(-c // 64))
    return max(1, -(-n_super // ng))


# ---------------------------------------------------------------------------
# Kernel A: int8 candidate cells, top-2 keys per (query, lane, group).
# ---------------------------------------------------------------------------


def i8_top2g_cells_plain(
    queries: torch.Tensor,  # (B_pad, D) int8, B_pad a multiple of 32
    corpus: torch.Tensor,  # (N_pad, D) int8, N_pad a multiple of 16,384
    *,
    group: int,
    sub: int,  # sub-blocks folded per step (block_c / 128)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of kernel A. Returns (k1, k2, s1, s2), each (B_pad,
    ng * 128) int32: column g * 128 + lane holds the top-2 keys of lane
    ``lane`` in group ``g`` and the absolute super index of each key.

    key = dot * 128 + _I8_FLAG128 + (sub-block position within its super).
    Per step of ``sub`` sub-blocks the exact top-2 keys are taken (keys of
    one step are distinct); steps fold into the group state in ascending
    order by the reference's merge (``_turbo_kernel_i8_top2g``), whose tie
    rules make the super labels depend on the step width. The dots run as
    a float32 product with TF32 off: every partial sum is an integer below
    2**24, so they are exact."""
    require_true_f32()
    b_pad = queries.shape[0]
    n_super = corpus.shape[0] // _TURBO_UNIT
    ng = -(-n_super // group)
    steps = _SUPER // sub  # steps per super
    qf = queries.float()
    dev = queries.device
    outs = [
        torch.empty((b_pad, ng * 128), dtype=torch.int32, device=dev)
        for _ in range(4)
    ]
    for g in range(ng):
        lo = g * group
        hi = min(lo + group, n_super)
        n_steps = (hi - lo) * steps
        docs = corpus[lo * _TURBO_UNIT : hi * _TURBO_UNIT].float()
        dots = (qf @ docs.T).to(torch.int32).view(b_pad, n_steps, sub, 128)
        pos = (torch.arange(n_steps * sub, device=dev) % _SUPER).view(
            n_steps, sub
        )
        keys = dots * 128 + (_I8_FLAG128 + pos).to(torch.int32)[None, :, :, None]
        if sub > 1:
            top2 = torch.topk(keys, 2, dim=2).values  # distinct within a step
            a1s, a2s = top2[:, :, 0], top2[:, :, 1]
        else:
            a1s = keys[:, :, 0]
            a2s = torch.zeros_like(a1s)  # sentinel: below every real key
        g1, g2 = a1s[:, 0], a2s[:, 0]
        s1 = torch.full_like(g1, lo)
        s2 = torch.full_like(g1, lo)
        for t in range(1, n_steps):
            a1, a2 = a1s[:, t], a2s[:, t]
            cur = torch.full_like(g1, lo + t // steps)
            upd1 = a1 > g1
            m = torch.minimum(g1, a1)  # displaced slot-1 loser
            sup_m = torch.where(upd1, s1, cur)
            c2 = torch.maximum(g2, a2)
            sup_c2 = torch.where(a2 > g2, cur, s2)
            g1 = torch.maximum(g1, a1)
            s1 = torch.where(upd1, cur, s1)
            g2 = torch.maximum(m, c2)
            s2 = torch.where(m >= c2, sup_m, sup_c2)
        for out, val in zip(outs, (g1, g2, s1, s2)):
            out[:, g * 128 : (g + 1) * 128] = val
    return tuple(outs)


def i8_top2g_cells(
    queries: torch.Tensor, corpus: torch.Tensor, *, group: int, sub: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel A (``csrc/i8_top2g.cu``) on CUDA tensors; its plain twin on
    CPU tensors. Same contract as :func:`i8_top2g_cells_plain`."""
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return i8_top2g_cells_plain(queries, corpus, group=group, sub=sub)
    _require_cuda(queries, corpus)
    b_pad, dim = queries.shape
    n_pad = corpus.shape[0]
    if queries.dtype != torch.int8 or corpus.dtype != torch.int8:
        raise TypeError("kernel A takes int8 queries and corpus")
    if corpus.shape[1] != dim or dim % 16 or b_pad % _I8_QUERY_TILE:
        raise ValueError(
            f"kernel A needs D % 16 == 0 and B % {_I8_QUERY_TILE} == 0; got "
            f"queries {tuple(queries.shape)}, corpus {tuple(corpus.shape)}"
        )
    if n_pad % _TURBO_UNIT or n_pad == 0 or _SUPER % sub:
        raise ValueError(f"corpus rows {n_pad} / sub {sub} off the unit")
    if not (queries.is_contiguous() and corpus.is_contiguous()):
        raise ValueError("kernel A takes contiguous row-major operands")
    if queries.data_ptr() % 16 or corpus.data_ptr() % 16:
        raise ValueError("kernel A reads 16-byte aligned rows")
    d64 = _round_up(dim, 64)  # the kernel's staged query row, = 64 (mod 128)
    stride = d64 if d64 % 128 == 64 else d64 + 64
    if _I8_QUERY_TILE * stride > _SMEM_LIMIT:
        raise ValueError(f"D={dim} exceeds kernel A's shared memory")
    n_super = n_pad // _TURBO_UNIT
    ng = -(-n_super // group)
    outs = [
        torch.empty((b_pad, ng * 128), dtype=torch.int32, device=queries.device)
        for _ in range(4)
    ]
    with torch.cuda.device(queries.device):
        _kernels.launch(
            "oi_i8_top2g",
            _kernels.ptr(queries), _kernels.ptr(corpus),
            *map(_kernels.ptr, outs),
            b_pad, dim, n_super, group, sub,
            _kernels.stream_of(queries),
        )
    i8_top2g_cells.launches += 1
    return tuple(outs)


i8_top2g_cells.launches = 0


def dense_topk_fast_i8_grouped(
    corpus: torch.Tensor,  # (N_pad, D) int8 quantised unit-norm rows
    queries: torch.Tensor,  # (B, D) int8 quantised unit-norm rows
    k: int = 10,
    block_c: int = 8192,
    n_docs: int | None = None,
    group: int = 8,  # supers folded per candidate pair
    plain: bool = False,  # run kernel A's plain twin (verification)
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 approximate cosine top-k: kernel A's candidate cells, then the
    decode and an exact top-k over ``2 * ng * 128`` columns (ties to the
    lower column, as ``lax.top_k``). Returns (vals (B, k) f32, ids (B, k)
    int32), padded with (0.0, -1); k beyond the candidate capacity clamps
    and pads. ``block_c`` (a multiple of 128 dividing 16,384) sets the
    step width of the fold, which the tie rules make part of the
    result."""
    if corpus.dtype != torch.int8 or queries.dtype != torch.int8:
        raise TypeError("dense_topk_fast_i8_grouped takes int8 operands")
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    if block_c % 128 or _TURBO_UNIT % block_c:
        raise ValueError("block_c must be a multiple of 128 dividing 16384")
    n_stored = corpus.shape[0]
    n_docs = n_stored if n_docs is None else n_docs
    b, dim = queries.shape
    if n_stored % _TURBO_UNIT or n_stored < _TURBO_UNIT:
        corpus = pad_corpus_i8(corpus)
    b_pad = _round_up(max(b, 1), _I8_QUERY_TILE)
    if b_pad != b:
        queries = torch.cat(
            [queries, queries.new_zeros((b_pad - b, dim))], dim=0
        )
    n_super = corpus.shape[0] // _TURBO_UNIT
    ng = -(-n_super // group)
    width = 2 * ng * 128
    k_req = k
    k = min(k, width)
    cells = i8_top2g_cells_plain if plain else i8_top2g_cells
    k1, k2, s1, s2 = cells(
        queries.contiguous(), corpus, group=group, sub=block_c // 128
    )

    keys = torch.cat([k1, k2], dim=1)  # (b_pad, width)
    sups = torch.cat([s1, s2], dim=1)
    lane = (torch.arange(width, device=keys.device) % 128).to(torch.int32)
    pos = keys & 127
    ids = (sups * (_TURBO_UNIT // 128) + pos) * 128 + lane[None, :]
    valid = (keys > 0) & (ids < n_docs)
    masked = torch.where(valid, keys, torch.full_like(keys, -(2**31)))
    kv, sel = stable_topk(masked, k)
    ids = torch.gather(ids, 1, sel)
    valid = torch.gather(valid, 1, sel)
    kv = torch.where(valid, kv, torch.full_like(kv, _I8_FLAG128))
    # XLA folds the reference's "/ 16129" into a multiply by the float32
    # reciprocal; the same multiply keeps the values bit-identical
    vals = ((kv - (kv & 127) - _I8_FLAG128) // 128).float() * (1.0 / _I8_SCALE)
    out_vals = torch.where(valid, vals, torch.zeros_like(vals))[:b]
    out_ids = torch.where(valid, ids, torch.full_like(ids, -1))[:b]
    if k < k_req:  # capacity-clamped: pad columns back to the requested k
        out_vals = torch.nn.functional.pad(out_vals, (0, k_req - k))
        out_ids = torch.nn.functional.pad(out_ids, (0, k_req - k), value=-1)
    return out_vals, out_ids


# ---------------------------------------------------------------------------
# Kernel B: exact fused cosine top-k.
# ---------------------------------------------------------------------------


def fused_topk_plain(
    doc_emb: torch.Tensor, queries: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of kernel B: exact cosine top-k in float32 (bf16 operands
    widen exactly), order (score desc, doc id asc); slots beyond the
    corpus are (0.0, -1)."""
    vals, ids = dense_topk_xla(doc_emb, queries, k)
    short = k - vals.shape[1]
    if short > 0:
        vals = torch.nn.functional.pad(vals, (0, short))
        ids = torch.nn.functional.pad(ids, (0, short), value=-1)
    return vals, ids


def fused_topk(
    doc_emb: torch.Tensor, queries: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B (``csrc/fused_topk.cu``) on CUDA tensors; its plain twin on
    CPU tensors. Same contract as :func:`fused_topk_plain`."""
    if doc_emb.device.type == "cpu" and queries.device.type == "cpu":
        return fused_topk_plain(doc_emb, queries, k)
    _require_cuda(doc_emb, queries)
    if doc_emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel B takes f32 or bf16 rows, got {doc_emb.dtype}")
    if queries.dtype != doc_emb.dtype:
        raise TypeError("kernel B takes queries of the corpus dtype")
    n_docs, dim = doc_emb.shape
    b = queries.shape[0]
    if queries.shape[1] != dim or not 1 <= k <= _FUSED_MAX_K or n_docs < 1:
        raise ValueError(
            f"kernel B: queries {tuple(queries.shape)}, corpus "
            f"{tuple(doc_emb.shape)}, k={k} (1 <= k <= {_FUSED_MAX_K})"
        )
    if 4 * (8 * dim + 32 * (dim + 1) + 16 * k) > _SMEM_LIMIT:
        raise ValueError(f"D={dim}, k={k} exceed kernel B's shared memory")
    dev = queries.device
    out_vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_vals, out_ids
    # corpus splits scored by separate blocks, merged by a second kernel (one
    # warp lane per split); at most 32, at least 512 docs each
    n_split = min(32, -(-n_docs // 512))
    split_len = _round_up(-(-n_docs // n_split), 32)
    part_vals = torch.empty((n_split, b, k), dtype=torch.float32, device=dev)
    part_ids = torch.empty((n_split, b, k), dtype=torch.int32, device=dev)
    queries = queries.contiguous()
    doc_emb = doc_emb.contiguous()
    with torch.cuda.device(dev):
        _kernels.launch(
            "oi_fused_topk",
            _kernels.ptr(queries), _kernels.ptr(doc_emb),
            int(doc_emb.dtype == torch.bfloat16),
            _kernels.ptr(part_vals), _kernels.ptr(part_ids),
            _kernels.ptr(out_vals), _kernels.ptr(out_ids),
            b, n_docs, dim, k, n_split, split_len,
            _kernels.stream_of(queries),
        )
    fused_topk.launches += 1
    unfilled = out_ids < 0
    return (
        torch.where(unfilled, torch.zeros_like(out_vals), out_vals),
        torch.where(unfilled, torch.full_like(out_ids, -1), out_ids),
    )


fused_topk.launches = 0


def dense_topk_pallas(
    doc_emb: torch.Tensor,  # (N, D) unit-norm rows, f32 or bf16
    queries: torch.Tensor,  # (B, D) unit-norm rows, same dtype as doc_emb
    k: int = 10,
    plain: bool = False,  # run kernel B's plain twin (verification)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused cosine top-k (the reference's ``dense_topk_pallas``). Returns
    (vals (B, k) f32, ids (B, k) int32); k > n_docs leaves (0.0, -1)
    slots."""
    if k > _FUSED_MAX_K:
        raise ValueError(f"k={k} exceeds the fused kernel's {_FUSED_MAX_K}")
    return (fused_topk_plain if plain else fused_topk)(doc_emb, queries, k)


def exact_rescore(
    doc_emb: torch.Tensor,  # (N, D) row-major bf16/f32 unit-norm rows
    queries: torch.Tensor,  # (B, D) f32/bf16 unit-norm
    cand_ids: torch.Tensor,  # (B, C) int32 candidate ids, -1 padded
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact float32 rescoring of a small candidate set: gather the
    candidates' rows and re-rank them by (score desc, doc id asc). Padding
    candidates come back as (0.0, -1)."""
    require_true_f32()
    cand = doc_emb[cand_ids.clamp(min=0).long()].float()  # (B, C, D)
    scores = torch.bmm(cand, queries.float()[:, :, None])[:, :, 0]
    scores = torch.where(
        cand_ids >= 0, scores, torch.full_like(scores, NEG_INF)
    )
    vals, ids = sort_by_score_then_id(scores, cand_ids)
    vals, ids = vals[:, :k], ids[:, :k]
    invalid = vals == NEG_INF
    return (
        torch.where(invalid, torch.zeros_like(vals), vals),
        torch.where(invalid, torch.full_like(ids, -1), ids),
    )


def _require_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "the kernels take tensors on one CUDA device (CPU tensors run "
            f"the plain twin); got {[str(t.device) for t in tensors]}"
        )


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    i8_top2g_cells.launches = 0
    fused_topk.launches = 0


def launch_counts() -> dict[str, int]:
    """Launches per kernel wrapper since the last reset."""
    return {
        "i8_top2g": i8_top2g_cells.launches,
        "fused_topk": fused_topk.launches,
    }
