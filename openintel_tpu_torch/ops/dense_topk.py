"""Dense candidate kernels for Hopper and their plain PyTorch twins.

Counterparts of :mod:`openintel_tpu.ops.pallas.dense_topk`:

- kernel A, ``csrc/i8_top2g_tma.cu`` (replaces ``_turbo_kernel_i8_top2g``):
  the int8 candidate pass of :func:`dense_topk_fast_i8_grouped`, the
  default dense arm at 100k docs and more, in two stages (per-step top-2s
  on the TMA + wgmma stream of ``csrc/tma_stream.cuh``, then the ordered
  group fold); the ``mma.sync`` kernel of ``csrc/i8_top2g.cu`` stays as
  the A/B control
  (:func:`i8_top2g_cells_v1`);
- kernel B, ``csrc/fused_topk_v2.cu`` (replaces ``_kernel`` of
  ``dense_topk_pallas``): the exact fused cosine top-k of
  :func:`dense_topk_pallas`, the dense arm of smaller corpora, on a
  ``cp.async`` ring; bf16 rows at k <= 32 also run on the same stream on
  request (``route="stream"``, measured slower); the first version,
  ``csrc/fused_topk.cu``, stays as the A/B control (:func:`fused_topk_v1`);
- kernel D (replaces ``_turbo_kernel_f32``): the f32/bf16 candidate cells
  of :func:`dense_topk_fast` (``kernel="fast"``), bf16 rows on the same
  stream (``csrc/turbo_bf16_tma.cu``), f32 rows by true-f32 FMA
  (``csrc/turbo_f32.cu``, whose bf16 kernel stays as the A/B control,
  :func:`fast_cells_v1`);
- kernels E1/E2, ``csrc/turbo_i4_tma.cu`` (replace ``_turbo_kernel_i4``
  and ``_turbo_kernel_i4_top2``): the int4 candidate cells of
  :func:`dense_topk_fast_i4` (``kernel="int4"`` runs E2) on the same
  stream, each packed tile unpacked once per block in shared memory; the
  ``mma.sync`` kernel of ``csrc/turbo_i4.cu`` stays as the A/B control
  (:func:`i4_cells_v1`);
- kernels C1/C2, ``csrc/turbo_i8_tma.cu`` (replace ``_turbo_kernel_i8``
  and ``_turbo_kernel_i8_top2``): the per-super int8 candidate cells of
  :func:`dense_topk_fast_i8`, which the candidate-pass measurement tools
  (``openintel_tpu_torch.tools``) run, on kernel A's stream; the
  ``mma.sync`` kernel of ``csrc/turbo_i8.cu`` stays as the A/B control
  (:func:`i8_turbo_cells_v1`);
- kernel S, ``csrc/dot_only_tma.cu`` (replaces ``_dot_only_kernel`` of
  ``scripts/bench_kernel_decomp.py``): :func:`dot_only`, the int8
  stream-floor probe, on kernel A's stream with the sums kept in the
  wgmma accumulators; the ``mma.sync`` kernel of ``csrc/dot_only.cu``
  stays as the A/B control (:func:`dot_only_cells_v1`);
- :func:`exact_rescore`, :func:`quantize_int8`, :func:`quantize_int4`,
  :func:`auto_i8_group` and the key constants, as torch ops.

Each kernel has a wrapper (:func:`i8_top2g_cells`, :func:`fused_topk`,
:func:`fast_cells`, :func:`i4_cells`, :func:`i8_turbo_cells`,
:func:`dot_only_cells`) and a plain twin of the same function
(``*_plain``). A wrapper given CPU tensors runs the twin; given CUDA
tensors it launches the kernel or raises. Each wrapper counts its launches
in its ``launches`` attribute. The A/B controls (``*_v1``) have their own
wrappers and counts; only ``chip_smoke.py`` and the card tests call them.

Layout: the candidate corpora are row-major, zero-padded to a multiple of
16,384 docs once at load (the JAX package streams the transposed
``(D, N_pad)`` copies its TPU kernels want): ``(N_pad, D)`` int8 for
kernels A, C and S, ``(N_pad, D)`` f32/bf16 rows for kernel D, and
``(N_pad / 2, D)`` bytes for kernels E, byte row r holding docs 2r (low
nibble) and 2r + 1 (high nibble). The int8/int4 cells are integer-exact,
so the port's candidates equal the reference's bit for bit. Kernel D's
keys hold the f32 bits of each dot, so they are bit-exact only where the
sum is exact in any order (dyadic operands); elsewhere a cell may move by
one score quantum (2**-16 for s + 2 in [1, 2), 2**-15 in [2, 4)).

The decodes of kernels C, D and E run an exact top-k, ties to the lower
column, where the reference runs ``approx_max_k``. On a TPU the port can
only find more candidates. On the CPU ``approx_max_k`` is exact and keeps
the lower column too, except when it selects every column: then it sorts
without a tie rule, and equal keys come out in an order the port does not
reproduce (the values and the set of ids still agree).
"""

from __future__ import annotations

import functools

import numpy as np
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
_I8_QUERY_TILE = 32  # queries per kernel-A/C/D/E/S block; batches pad to it
_FUSED_MAX_K = 1024  # the reference kernel's k <= block_c bound
FEATURE_MULTIPLE = 16  # the card kernels take D a multiple of this (pad_features)
# Kernel B v2 (csrc/fused_topk_v2.cu): per-row candidate buffer, the query
# tile and its doc tile by batch, blocks wanted per SM
_FUSED_MIN_CAP = 32  # a warp's ballot appends up to 32 at once
_FUSED_LIST_SMEM = 32 * 1024  # bytes of a block's lists kept in shared memory
_FUSED_CAP = 64  # candidate buffer when the lists live in device memory (large k)
_FUSED_TILE_DOCS = 128  # docs per tile
_FUSED_BLOCKS_PER_SM = {16: 2, 64: 1}  # by query rows (8 and 16 warps a block)
# bf16 rows at k <= this may take the TMA + wgmma stream (64 shared slots a
# row: the list and a buffer of at least 32)
_FUSED_STREAM_MAX_K = 32
_STREAM_QUERY_ROWS = 128  # queries per block of the stream (csrc/tma_stream.cuh)
_STREAM_MAX_PARTS = 16  # parts a super may be split into on the stream
_SMEM_LIMIT = 232_448  # dynamic shared memory one H100 block may use
_POS_BITS = 7  # kernel D: sub-block position within a super
_POS_MASK = (1 << _POS_BITS) - 1  # 127
_SHIFT = 2.0  # kernel D: score -> strictly positive float, bits monotonic
_I4_SCALE_DEFAULT = 32.0  # int4 corpus: clip at |x| = 8 / 32 = 0.25
_I4_SUPER_B = _SUPER // 2  # byte sub-tiles (of 128 byte rows) per super
_I4_DIM_LIMIT = 8_000  # D below it keeps dot * 128 + _I8_FLAG128 in (0, 2**31)
_INT32_MIN = -(2**31)
_TWIN_CHUNK_SUPERS = 8  # supers per product in the plain twins of C, D, E, S
# Parts a super may be split into by kernels C and E, by slot count (slots
# 1 meet by atomicMax, slots 2 through buffers merged by a second kernel;
# PERF.md has E2's and C2's measurements)
_MAX_PARTS = {1: 16, 2: 2}
_S_MAX_PARTS = 16  # kernel S: parts a super may be split into
_S_PAIRED = True  # kernel S served in 2-block clusters (PERF.md: paired vs unpaired)
_S_DOT_MAX = 128 * 128  # |q * d| of one int8 feature pair, at most


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def quantize_int8(emb: torch.Tensor) -> torch.Tensor:
    """round(127 * x) for unit-norm embeddings, clipped to [-127, 127]
    (round half to even, as ``np.rint``)."""
    x = emb.float()
    return torch.clamp(torch.round(127.0 * x), -127, 127).to(torch.int8)


def quantize_int4(emb: torch.Tensor, scale: float = _I4_SCALE_DEFAULT) -> torch.Tensor:
    """clip(round(scale * x), -8, 7) for unit-norm embeddings (round half
    to even, as ``np.rint``), as int8 values."""
    return torch.clamp(torch.round(scale * emb.float()), -8, 7).to(torch.int8)


def pad_corpus_rows(corpus: torch.Tensor, width: int | None = None) -> torch.Tensor:
    """Zero-pad an (N, D) corpus (int8, f32 or bf16 rows) to a multiple of
    16,384 rows (at least one super), the row-major ``pad_corpus_t``, and
    its feature axis to ``width`` columns (default D), in one copy; the
    corpus itself when it fits already. Done once at index load: the hot
    path must never copy the corpus."""
    n, dim = corpus.shape
    n_pad = _round_up(max(n, _TURBO_UNIT), _TURBO_UNIT)
    width = dim if width is None else width
    if (n_pad, width) == (n, dim):
        return corpus
    out = torch.zeros((n_pad, width), dtype=corpus.dtype, device=corpus.device)
    out[:n, :dim] = corpus
    return out


def padded_dim(dim: int) -> int:
    """The feature width the card kernels take for ``dim`` columns: the next
    multiple of ``FEATURE_MULTIPLE`` (16; 16 bytes a row at int8, 32 at
    bf16, 64 at f32)."""
    return _round_up(dim, FEATURE_MULTIPLE)


def pad_features(x: torch.Tensor, width: int | None = None) -> torch.Tensor:
    """Zero-pad the feature (last) axis of ``x`` to ``width`` columns, by
    default :func:`padded_dim`.
    Exact: a zero column adds 0 to every int32 dot and float32 sum. Returns
    ``x`` itself when it already has that width; else a copy, so the
    corpora are padded once when they are built and only queries per
    call."""
    dim = x.shape[-1]
    width = padded_dim(dim) if width is None else width
    if width == dim:
        return x
    if width < dim:
        raise ValueError(f"cannot pad {dim} features down to {width}")
    return torch.nn.functional.pad(x, (0, width - dim))


def _pack_pairs(x4: torch.Tensor) -> torch.Tensor:
    """(2M, D) int4-valued int8 rows -> (M, D) bytes: byte row r holds row
    2r in its low nibble and row 2r + 1 in its high nibble."""
    v = x4.to(torch.int32) & 15
    return ((v[1::2] << 4) | v[0::2]).to(torch.uint8).view(torch.int8)


def pack_corpus_i4(x4: torch.Tensor) -> torch.Tensor:
    """Pack an (N, D) int4-valued int8 corpus into (N_pad / 2, D) bytes,
    N_pad = N zero-padded to a multiple of 16,384 once, at load: the
    row-major ``pack_corpus_t_i4`` (its byte column c is byte row c
    here)."""
    return _pack_pairs(pad_corpus_rows(x4))


def _row_stride(row_bytes: int) -> int:
    """Bytes per staged query row in kernels A, C, D, E and S (``row_stride`` in
    ``csrc/i8_top2g.cu`` and ``csrc/turbo_common.cuh``): whole 64-byte
    chunks, = 64 (mod 128)."""
    d64 = _round_up(row_bytes, 64)
    return d64 if d64 % 128 == 64 else d64 + 64


def _pad_query_rows(queries: torch.Tensor, tile: int) -> torch.Tensor:
    b, dim = queries.shape
    b_pad = _round_up(max(b, 1), tile)
    if b_pad == b:
        return queries
    return torch.cat([queries, queries.new_zeros((b_pad - b, dim))], dim=0)


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
        state = _fold_steps_in_order(a1s.transpose(0, 1), a2s.transpose(0, 1), lo, steps)
        for out, val in zip(outs, state):
            out[:, g * 128 : (g + 1) * 128] = val
    return tuple(outs)


def _fold_steps_in_order(a1s, a2s, lo: int, steps_per_super: int):
    """The reference's group fold (``_turbo_kernel_i8_top2g``): the steps'
    top-2 keys (a1s, a2s: (n_steps, ...) int32, step t in super lo + t //
    steps_per_super) merged one after the other into (g1, g2, s1, s2).
    Ties keep the incumbent in slot 1, and the merge is not associative, so
    the order is part of the result."""
    g1, g2 = a1s[0], a2s[0]
    s1 = torch.full_like(g1, lo)
    s2 = torch.full_like(g1, lo)
    for t in range(1, a1s.shape[0]):
        a1, a2 = a1s[t], a2s[t]
        cur = torch.full_like(g1, lo + t // steps_per_super)
        upd1 = a1 > g1
        m = torch.minimum(g1, a1)  # displaced slot-1 loser
        sup_m = torch.where(upd1, s1, cur)
        c2 = torch.maximum(g2, a2)
        sup_c2 = torch.where(a2 > g2, cur, s2)
        g1 = torch.maximum(g1, a1)
        s1 = torch.where(upd1, cur, s1)
        g2 = torch.maximum(m, c2)
        s2 = torch.where(m >= c2, sup_m, sup_c2)
    return g1, g2, s1, s2


def i8_step_tops_plain(
    queries: torch.Tensor,  # (B_pad, D) int8, B_pad a multiple of 32
    corpus: torch.Tensor,  # (N_pad, D) int8, N_pad a multiple of 16,384
    *,
    sub: int,  # sub-blocks per step (block_c / 128)
) -> torch.Tensor:
    """Plain twin of kernel A's first stage (``csrc/i8_top2g_tma.cu``).
    Returns (n_steps, B_pad, 128, 2) int32, n_steps = n_super * 128 / sub:
    entry (t, b, lane) holds the top-2 keys of (query b, lane) over step
    t's ``sub`` sub-blocks (super t // (128 / sub)); slot 2 is the
    reference's sentinel 0 when ``sub`` is 1. Keys of a step are distinct,
    so this stage is order-free."""
    require_true_f32()
    b_pad = queries.shape[0]
    n_super = corpus.shape[0] // _TURBO_UNIT
    steps = _SUPER // sub
    qf = queries.float()
    out = torch.empty((n_super * steps, b_pad, 128, 2), dtype=torch.int32, device=queries.device)
    pos = (_I8_FLAG128 + torch.arange(_SUPER, device=queries.device)).to(torch.int32)
    for lo in range(0, n_super, _TWIN_CHUNK_SUPERS):
        hi = min(lo + _TWIN_CHUNK_SUPERS, n_super)
        docs = corpus[lo * _TURBO_UNIT : hi * _TURBO_UNIT].float()
        dots = (qf @ docs.T).to(torch.int32).view(b_pad, (hi - lo) * steps, sub, 128)
        keys = dots * 128 + pos.repeat(hi - lo).view(1, -1, sub, 1)
        if sub > 1:
            top2 = torch.topk(keys, 2, dim=2).values  # distinct within a step
            a1, a2 = top2[:, :, 0], top2[:, :, 1]
        else:
            a1 = keys[:, :, 0]
            a2 = torch.zeros_like(a1)
        out[lo * steps : hi * steps] = torch.stack([a1, a2], dim=-1).transpose(0, 1)
    return out


def i8_fold_steps_plain(
    steps: torch.Tensor, *, n_super: int, group: int, sub: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of kernel A's second stage: each group's steps (from
    :func:`i8_step_tops_plain`) folded in ascending order by the
    reference's merge. Returns (k1, k2, s1, s2) as
    :func:`i8_top2g_cells_plain` does."""
    per_super = _SUPER // sub
    b_pad = steps.shape[1]
    ng = -(-n_super // group)
    outs = [
        torch.empty((b_pad, ng * 128), dtype=torch.int32, device=steps.device)
        for _ in range(4)
    ]
    for g in range(ng):
        lo = g * group
        hi = min(lo + group, n_super)
        part = steps[lo * per_super : hi * per_super]
        state = _fold_steps_in_order(part[..., 0], part[..., 1], lo, per_super)
        for out, val in zip(outs, state):
            out[:, g * 128 : (g + 1) * 128] = val
    return tuple(outs)


def _check_i8_cells_operands(name, queries, corpus, sub, *, staged: bool) -> int:
    """Kernel A's operands (both versions); returns n_super. ``staged``: the
    32-query tile of the ``mma.sync`` kernel sits whole in shared memory."""
    b_pad, dim = queries.shape
    n_pad = corpus.shape[0]
    if queries.dtype != torch.int8 or corpus.dtype != torch.int8:
        raise TypeError(f"{name} takes int8 queries and corpus")
    if corpus.shape[1] != dim or dim % 16 or b_pad % _I8_QUERY_TILE:
        raise ValueError(
            f"{name} needs D % 16 == 0 and B % {_I8_QUERY_TILE} == 0; got "
            f"queries {tuple(queries.shape)}, corpus {tuple(corpus.shape)}"
        )
    if n_pad % _TURBO_UNIT or n_pad == 0 or _SUPER % sub:
        raise ValueError(f"corpus rows {n_pad} / sub {sub} off the unit")
    if not (queries.is_contiguous() and corpus.is_contiguous()):
        raise ValueError(f"{name} takes contiguous row-major operands")
    if queries.data_ptr() % 16 or corpus.data_ptr() % 16:
        raise ValueError(f"{name} reads 16-byte aligned rows")
    if staged and _I8_QUERY_TILE * _row_stride(dim) > _SMEM_LIMIT:
        raise ValueError(f"D={dim} exceeds {name}'s shared memory")
    return n_pad // _TURBO_UNIT


def _i8_cells_out(b_pad, device, n_super, group):
    ng = -(-n_super // group)
    return [
        torch.empty((b_pad, ng * 128), dtype=torch.int32, device=device)
        for _ in range(4)
    ]


def i8_top2g_cells(
    queries: torch.Tensor, corpus: torch.Tensor, *, group: int, sub: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel A (``csrc/i8_top2g_tma.cu``: TMA + wgmma per-step top-2s,
    then the ordered group fold, both launched by one call) on CUDA
    tensors; its plain twin on CPU tensors. Same contract as
    :func:`i8_top2g_cells_plain`."""
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return i8_top2g_cells_plain(queries, corpus, group=group, sub=sub)
    _require_cuda(queries, corpus)
    n_super = _check_i8_cells_operands("kernel A", queries, corpus, sub, staged=False)
    b_pad, dim = queries.shape
    outs = _i8_cells_out(b_pad, queries.device, n_super, group)
    steps = torch.empty(
        (n_super * (_SUPER // sub), b_pad, 128, 2), dtype=torch.int32, device=queries.device
    )
    with torch.cuda.device(queries.device):
        _kernels.launch(
            "oi_i8_top2g_tma",
            _kernels.ptr(queries), _kernels.ptr(corpus),
            *map(_kernels.ptr, outs), _kernels.ptr(steps),
            b_pad, dim, n_super, group, sub,
            _kernels.stream_of(queries),
        )
    i8_top2g_cells.launches += 1
    return tuple(outs)


i8_top2g_cells.launches = 0


def i8_fold_steps(
    steps: torch.Tensor, *, n_super: int, group: int, sub: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel A's second stage alone (``oi_i8_fold``) on a CUDA steps
    tensor laid out as :func:`i8_step_tops_plain` returns it; its plain
    twin on a CPU one. For checking and timing the fold apart; the search
    path never calls it."""
    if steps.device.type == "cpu":
        return i8_fold_steps_plain(steps, n_super=n_super, group=group, sub=sub)
    _require_cuda(steps)
    b_pad = steps.shape[1]
    if (steps.dtype != torch.int32 or not steps.is_contiguous()
            or steps.shape != (n_super * (_SUPER // sub), b_pad, 128, 2)):
        raise ValueError(f"steps {tuple(steps.shape)} do not fit n_super={n_super}, sub={sub}")
    outs = _i8_cells_out(b_pad, steps.device, n_super, group)
    with torch.cuda.device(steps.device):
        _kernels.launch(
            "oi_i8_fold", _kernels.ptr(steps), *map(_kernels.ptr, outs),
            b_pad, n_super, group, sub, _kernels.stream_of(steps),
        )
    i8_fold_steps.launches += 1
    return tuple(outs)


i8_fold_steps.launches = 0


def i8_top2g_cells_v1(
    queries: torch.Tensor, corpus: torch.Tensor, *, group: int, sub: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel A's ``mma.sync`` version (``csrc/i8_top2g.cu``, one warp per
    (32 queries, 8 lanes, group)), the control of A/B runs; its plain twin
    on CPU tensors. Same contract as :func:`i8_top2g_cells_plain`."""
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return i8_top2g_cells_plain(queries, corpus, group=group, sub=sub)
    _require_cuda(queries, corpus)
    n_super = _check_i8_cells_operands("kernel A v1", queries, corpus, sub, staged=True)
    b_pad, dim = queries.shape
    outs = _i8_cells_out(b_pad, queries.device, n_super, group)
    with torch.cuda.device(queries.device):
        _kernels.launch(
            "oi_i8_top2g",
            _kernels.ptr(queries), _kernels.ptr(corpus),
            *map(_kernels.ptr, outs),
            b_pad, dim, n_super, group, sub,
            _kernels.stream_of(queries),
        )
    i8_top2g_cells_v1.launches += 1
    return tuple(outs)


i8_top2g_cells_v1.launches = 0


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
    result. A feature width that is not a multiple of 16 is zero-padded
    here (:func:`pad_features`), a copy of the corpus per call: the
    retrievers pad theirs once at load."""
    if corpus.dtype != torch.int8 or queries.dtype != torch.int8:
        raise TypeError("dense_topk_fast_i8_grouped takes int8 operands")
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    if block_c % 128 or _TURBO_UNIT % block_c:
        raise ValueError("block_c must be a multiple of 128 dividing 16384")
    corpus = pad_features(corpus)  # a copy per call unless padded at load
    queries = pad_features(queries, corpus.shape[1])
    n_stored = corpus.shape[0]
    n_docs = n_stored if n_docs is None else n_docs
    b = queries.shape[0]
    if n_stored % _TURBO_UNIT or n_stored < _TURBO_UNIT:
        corpus = pad_corpus_rows(corpus)
    queries = _pad_query_rows(queries, _I8_QUERY_TILE)
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
    masked = torch.where(valid, keys, torch.full_like(keys, _INT32_MIN))
    kv, sel = stable_topk(masked, k)
    ids = torch.gather(ids, 1, sel)
    valid = torch.gather(valid, 1, sel)
    kv = torch.where(valid, kv, torch.full_like(kv, _I8_FLAG128))
    # XLA folds the reference's "/ 16129" into a multiply by the float32
    # reciprocal; the same multiply keeps the values bit-identical
    vals = ((kv - (kv & 127) - _I8_FLAG128) // 128).float() * (1.0 / _I8_SCALE)
    return _finish(vals, ids, valid, b, k_req)


def _pad_columns(vals, ids, k_req):
    """Pad capacity-clamped (vals, ids) with (0.0, -1) back to k_req."""
    short = k_req - vals.shape[1]
    if short > 0:
        vals = torch.nn.functional.pad(vals, (0, short))
        ids = torch.nn.functional.pad(ids, (0, short), value=-1)
    return vals, ids


def _check_turbo_operands(name, queries, corpus, row_bytes: int, staged: bool = True) -> None:
    """The layout kernels C, D, E and S take: contiguous 16-byte aligned
    rows, query rows padded to the 32-query tile and, for the ``mma.sync``
    kernels (``staged``), the staged tile within shared memory (kernel D's
    TMA kernel streams query boxes that do not fit)."""
    b_pad, dim = queries.shape
    if corpus.shape[1] != dim or row_bytes % 16 or b_pad % _I8_QUERY_TILE:
        raise ValueError(
            f"{name} needs 16-byte rows and B % {_I8_QUERY_TILE} == 0; got "
            f"queries {tuple(queries.shape)}, corpus {tuple(corpus.shape)}"
        )
    if not (queries.is_contiguous() and corpus.is_contiguous()):
        raise ValueError(f"{name} takes contiguous row-major operands")
    if queries.data_ptr() % 16 or corpus.data_ptr() % 16:
        raise ValueError(f"{name} reads 16-byte aligned rows")
    if staged and _I8_QUERY_TILE * _row_stride(row_bytes) > _SMEM_LIMIT:
        raise ValueError(f"D={dim} exceeds {name}'s shared memory")


def _select_and_compact(packed, k, k_fetch, decode):
    """The reference's candidate selection: the top ``k_fetch`` packed keys
    by their float32 view (``approx_max_k``; exact here, ties to the lower
    column), ``decode`` -> (ids, vals, valid), then, when over-fetched, an
    exact top-k of the keys with the invalid ones pushed to -2**31. Returns
    (vals, ids, valid), each (B, k)."""
    fv, pcols = stable_topk(packed.view(torch.float32), k_fetch)
    pvals = fv.view(torch.int32)
    ids, vals, valid = decode(pvals, pcols)
    if k_fetch > k:
        key = torch.where(valid, pvals, torch.full_like(pvals, _INT32_MIN))
        _, sel = stable_topk(key, k)
        ids, vals, valid = (torch.gather(t, 1, sel) for t in (ids, vals, valid))
    return vals, ids, valid


def _finish(vals, ids, valid, b, k_req):
    out_vals = torch.where(valid, vals, torch.zeros_like(vals))[:b]
    out_ids = torch.where(valid, ids, torch.full_like(ids, -1))[:b]
    return _pad_columns(out_vals, out_ids, k_req)


def _check_i8_operands(name, queries, corpus, *, staged: bool = True) -> int:
    """Kernels C and S take kernel A's operands: int8 queries padded to the
    32-query tile and the row-major (N_pad, D) int8 corpus. Returns
    n_super. ``staged``: the 32-query tile of the ``mma.sync`` kernels sits
    whole in shared memory."""
    if queries.dtype != torch.int8 or corpus.dtype != torch.int8:
        raise TypeError(f"{name} takes int8 queries and corpus")
    n_pad = corpus.shape[0]
    if n_pad % _TURBO_UNIT or n_pad == 0:
        raise ValueError(f"{name}: corpus rows {n_pad} off the 16,384-doc unit")
    _check_turbo_operands(name, queries, corpus, queries.shape[1], staged=staged)
    return n_pad // _TURBO_UNIT


def _check_parts(parts: int, slots: int) -> None:
    if parts < 1 or _SUPER % parts or _SUPER // parts < slots:
        raise ValueError(f"parts must divide 128 into runs of >= {slots}, got {parts}")


def _part_tops(chunks, queries, n_super: int, slots: int, parts: int) -> torch.Tensor:
    """The twins of kernels C and E: per part of each super's 128 sub-blocks,
    the top ``slots`` of each cell's keys (distinct, so unique), from a key
    generator as :func:`_i8_key_chunks` yields. Returns (parts, B_pad,
    slots * n_super * 128) int32, slot j's half after slot j - 1's."""
    b_pad = queries.shape[0]
    half = n_super * 128
    out = torch.empty((parts, b_pad, slots * half), dtype=torch.int32, device=queries.device)
    for lo, hi, keys in chunks:
        runs = keys.view(b_pad, hi - lo, parts, _SUPER // parts, 128)
        top = torch.topk(runs, slots, dim=3).values.permute(2, 0, 1, 3, 4)
        for j in range(slots):  # top: (parts, b_pad, supers, slot, lane)
            out[:, :, j * half + lo * 128 : j * half + hi * 128] = (
                top[:, :, :, j].reshape(parts, b_pad, -1)
            )
    return out


def _launch_cells(entry, queries, corpus, n_super, slots, max_parts) -> torch.Tensor:
    """Kernels C's or E's stream kernel (``entry``) on checked CUDA
    operands: (B_pad, slots * n_super * 128) int32 cells, supers split into
    at most ``max_parts`` parts (default ``_MAX_PARTS``)."""
    max_parts = _MAX_PARTS[slots] if max_parts is None else max_parts
    if max_parts < 1:
        raise ValueError(f"max_parts must be >= 1, got {max_parts}")
    b_pad, dim = queries.shape
    dev = queries.device
    out = torch.empty((b_pad, slots * n_super * 128), dtype=torch.int32, device=dev)
    # slots 2: the parts after the first write buffers of their own; slots 1
    # meet in out
    n_scratch = (max_parts - 1) * out.numel() if slots == 2 else 0
    parts_out = torch.empty((n_scratch,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _kernels.launch(
            entry,
            _kernels.ptr(queries), _kernels.ptr(corpus), _kernels.ptr(out),
            _kernels.ptr(parts_out), slots, b_pad, dim, n_super, max_parts,
            _kernels.stream_of(queries),
        )
    return out


def _launch_cells_v1(entry, queries, corpus, n_super, slots) -> torch.Tensor:
    """Kernels C's or E's ``mma.sync`` control (``entry``) on checked CUDA
    operands."""
    b_pad, dim = queries.shape
    out = torch.empty(
        (b_pad, slots * n_super * 128), dtype=torch.int32, device=queries.device
    )
    with torch.cuda.device(queries.device):
        _kernels.launch(
            entry,
            _kernels.ptr(queries), _kernels.ptr(corpus), _kernels.ptr(out),
            slots, b_pad, dim, n_super, _kernels.stream_of(queries),
        )
    return out


# ---------------------------------------------------------------------------
# Kernels C1/C2: int8 candidate cells, top-1 or top-2 keys per (query,
# super, lane).
# ---------------------------------------------------------------------------


def _i8_key_chunks(queries: torch.Tensor, corpus: torch.Tensor):
    """Kernels C's keys, a few supers at a time: yields (lo, hi, keys) with
    keys (B_pad, hi - lo, 128 pos, 128 lanes) int32 for supers lo .. hi - 1.
    The dots run as a float32 product with TF32 off: every partial sum is
    an integer below 2**24."""
    require_true_f32()
    b_pad = queries.shape[0]
    n_super = corpus.shape[0] // _TURBO_UNIT
    qf = queries.float()
    pos = (_I8_FLAG128 + torch.arange(_SUPER, dtype=torch.int32, device=queries.device))
    pos = pos[None, None, :, None]
    for lo in range(0, n_super, _TWIN_CHUNK_SUPERS):
        hi = min(lo + _TWIN_CHUNK_SUPERS, n_super)
        docs = corpus[lo * _TURBO_UNIT : hi * _TURBO_UNIT].float()
        dots = (qf @ docs.T).to(torch.int32).view(b_pad, hi - lo, _SUPER, 128)
        yield lo, hi, dots * 128 + pos


def i8_turbo_cells_plain(
    queries: torch.Tensor,  # (B_pad, D) int8, B_pad a multiple of 32
    corpus: torch.Tensor,  # (N_pad, D) int8, N_pad a multiple of 16,384
    *,
    slots: int,
) -> torch.Tensor:
    """Plain twin of kernels C1 (``slots=1``) and C2 (``slots=2``). Returns
    (B_pad, slots * n_super * 128) int32: column s * 128 + lane of slot j's
    half holds the j-th largest over the super's 128 keys of its lane,

        key = dot * 128 + _I8_FLAG128 + pos,

    for doc s * 16384 + 128 * pos + lane. All supers' slot-1 keys come
    first, then all their slot-2 keys (the reference's ``concat(p1, p2)``).
    A cell's keys are distinct (pos differs), so its top-2 is unique and
    depends on neither the walk order nor ``block_c``. Zero-padded docs
    give real keys; only the decode drops them."""
    n_super = corpus.shape[0] // _TURBO_UNIT
    return _part_tops(_i8_key_chunks(queries, corpus), queries, n_super, slots, 1)[0]


def i8_turbo_part_cells_plain(
    queries: torch.Tensor, corpus: torch.Tensor, *, slots: int, parts: int
) -> torch.Tensor:
    """Plain twin of kernels C's parts before they meet
    (``csrc/turbo_i8_tma.cu`` splits each super's 128 sub-blocks into
    ``parts`` runs of 128 / parts). Returns (parts, B_pad, slots * n_super *
    128) int32: buffer p holds, in :func:`i8_turbo_cells_plain`'s layout,
    the top ``slots`` keys of each cell over pos in [p * 128 / parts,
    (p + 1) * 128 / parts). :func:`merge_part_cells_plain` meets them."""
    _check_parts(parts, slots)
    n_super = corpus.shape[0] // _TURBO_UNIT
    return _part_tops(_i8_key_chunks(queries, corpus), queries, n_super, slots, parts)


def i8_turbo_cells(
    queries: torch.Tensor, corpus: torch.Tensor, *, slots: int, max_parts: int | None = None
) -> torch.Tensor:
    """Kernel C1 (``slots=1``) or C2 (``slots=2``) on CUDA tensors: kernel
    A's TMA + wgmma stream (``csrc/turbo_i8_tma.cu``); their plain twin on
    CPU tensors. Same contract as :func:`i8_turbo_cells_plain`, any D (a
    multiple of 16). ``max_parts`` caps the parts a super is split into
    for an even spread over the SMs (default ``_MAX_PARTS``); the cells
    do not depend on it. ``launches`` counts each slot count apart."""
    if slots not in (1, 2):
        raise ValueError(f"slots must be 1 or 2, got {slots}")
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return i8_turbo_cells_plain(queries, corpus, slots=slots)
    _require_cuda(queries, corpus)
    n_super = _check_i8_operands("kernels C", queries, corpus, staged=False)
    out = _launch_cells("oi_turbo_i8_tma", queries, corpus, n_super, slots, max_parts)
    i8_turbo_cells.launches[slots] += 1
    return out


i8_turbo_cells.launches = {1: 0, 2: 0}


def i8_turbo_cells_v1(queries: torch.Tensor, corpus: torch.Tensor, *, slots: int) -> torch.Tensor:
    """Kernels C's ``mma.sync`` version (``csrc/turbo_i8.cu``), the control
    of A/B runs; its plain twin on CPU tensors. Same contract as
    :func:`i8_turbo_cells_plain`; its 32-query tile must fit in shared
    memory."""
    if slots not in (1, 2):
        raise ValueError(f"slots must be 1 or 2, got {slots}")
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return i8_turbo_cells_plain(queries, corpus, slots=slots)
    _require_cuda(queries, corpus)
    n_super = _check_i8_operands("kernels C v1", queries, corpus)
    out = _launch_cells_v1("oi_turbo_i8", queries, corpus, n_super, slots)
    i8_turbo_cells_v1.launches[slots] += 1
    return out


i8_turbo_cells_v1.launches = {1: 0, 2: 0}


def dense_topk_fast_i8(
    corpus: torch.Tensor,  # (N_pad, D) int8 quantised unit-norm rows (pad_corpus_rows)
    queries: torch.Tensor,  # (B, D) int8 quantised unit-norm rows
    k: int = 10,
    block_c: int = 8192,
    n_docs: int | None = None,
    slots: int = 2,  # candidate slots per (super, lane): 1 or 2
    plain: bool = False,  # run the kernels' plain twin (verification)
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 approximate cosine top-k from kernel C1/C2's per-super cells
    (the reference's ``dense_topk_fast_i8``). Returns (vals (B, k) f32,
    ids (B, k) int32), padded with (0.0, -1); k beyond the capacity of
    128 * slots per super clamps and pads. Pass :func:`pad_corpus_rows`
    rows and the true ``n_docs``: unpadded rows pay a corpus copy per call,
    and so does a feature width that is not a multiple of 16
    (:func:`pad_features`). ``block_c`` (a multiple of 128 dividing 16,384)
    is validated as the reference does; the cells do not depend on it."""
    if corpus.dtype != torch.int8 or queries.dtype != torch.int8:
        raise TypeError("dense_topk_fast_i8 takes int8 operands")
    if slots not in (1, 2):
        raise ValueError(f"slots must be 1 or 2, got {slots}")
    if block_c % 128 or _TURBO_UNIT % block_c:
        raise ValueError("block_c must be a multiple of 128 dividing 16384")
    corpus = pad_features(corpus)  # a copy per call unless padded at load
    queries = pad_features(queries, corpus.shape[1])
    n_stored = corpus.shape[0]
    n_docs = n_stored if n_docs is None else n_docs
    b = queries.shape[0]
    if n_stored % _TURBO_UNIT or n_stored < _TURBO_UNIT:
        corpus = pad_corpus_rows(corpus)
    queries = _pad_query_rows(queries, _I8_QUERY_TILE)
    n_super = corpus.shape[0] // _TURBO_UNIT
    lanes = 128 * slots
    k_req = k
    k = min(k, n_super * lanes)
    half = n_super * 128
    cells = i8_turbo_cells_plain if plain else i8_turbo_cells
    packed = cells(queries.contiguous(), corpus, slots=slots)
    # the reference's over-fetch: `lanes` slots where zero-padding may
    # shadow negative-scored docs of a small corpus, else the 32-slot margin
    padded = corpus.shape[0] != n_docs
    pad_slots = lanes if (padded and n_docs <= 262_144) else 0
    k_fetch = min(k + max(pad_slots, 32), n_super * lanes)

    def decode(pvals, pcols):
        pos = pvals & 127  # sub-block within the super
        col = pcols % half  # both slot halves decode alike
        ids = (((col // 128) * 128 + pos) * 128 + col % 128).to(torch.int32)
        # XLA folds the reference's "/ 16129" into a multiply by the
        # float32 reciprocal; the same multiply keeps the values bit-identical
        vals = ((pvals - pos - _I8_FLAG128) // 128).float() * (1.0 / _I8_SCALE)
        return ids, vals, (ids < n_docs) & (pvals > 0)

    vals, ids, valid = _select_and_compact(packed, k, k_fetch, decode)
    return _finish(vals, ids, valid, b, k_req)


# ---------------------------------------------------------------------------
# Kernel S: the dot-only stream probe, per-lane sums of every int8 dot.
# ---------------------------------------------------------------------------


def _int8_dot_chunks(queries: torch.Tensor, corpus: torch.Tensor):
    """Every int8 dot of kernel S, a few supers at a time: yields (lo, hi,
    dots) with dots (B_pad, hi - lo, 128 pos, 128 lanes) int64 for supers
    lo .. hi - 1. A float32 product (TF32 off) while every partial sum is
    an integer below 2**24 (D * 128**2 < 2**24), else float64: exact
    either way."""
    require_true_f32()
    b_pad, dim = queries.shape
    n_super = corpus.shape[0] // _TURBO_UNIT
    exact = torch.float32 if dim * _S_DOT_MAX < 2**24 else torch.float64
    qf = queries.to(exact)
    for lo in range(0, n_super, _TWIN_CHUNK_SUPERS):
        hi = min(lo + _TWIN_CHUNK_SUPERS, n_super)
        docs = corpus[lo * _TURBO_UNIT : hi * _TURBO_UNIT].to(exact)
        yield lo, hi, (qf @ docs.T).to(torch.int64).view(b_pad, hi - lo, _SUPER, 128)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def dot_only_plain(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Plain twin of kernel S. Returns (B_pad, 128) int32: column l holds
    the sum of dot(q, doc) over every doc of the padded corpus with
    id % 128 == l, wrapped mod 2**32 as the reference's int32 adds wrap
    (summed here in int64, then wrapped)."""
    acc = torch.zeros((queries.shape[0], 128), dtype=torch.int64, device=queries.device)
    for _, _, dots in _int8_dot_chunks(queries, corpus):
        acc += dots.sum(dim=(1, 2))
    return _wrap_int32(acc)


def dot_only_run(dim: int, parts: int, run_cap: int = 0) -> int:
    """Kernel S's run (``csrc/dot_only_tma.cu``): the sub-blocks of a part
    (128 / ``parts``) whose dots a pair of accumulator sets sums in place
    before the sums go to the output, halved until no set's int32 sum can
    overflow (run / 2 dots of at most 16,384 D each); ``run_cap`` > 0
    caps it there instead, overflow or not (a measurement). A power of
    two, at least 2. On the card a ``run_cap`` also caps the parts at
    128 / ``run_cap``, so that a part holds a whole run."""
    run = _SUPER // parts
    while run > 2 and (
        run > run_cap if run_cap else (run // 2) * dim * _S_DOT_MAX > 2**31 - 1
    ):
        run //= 2
    return run


def dot_only_plan(
    b_pad: int, n_super: int, dim: int, *, sms: int = 132, run_cap: int = 0
) -> dict:
    """Kernel S's launch plan as ``oi_dot_only_tma`` makes it: ``parts``
    and ``ctas_per_qt`` by ``plan_grid`` (at most 16 parts; 128 /
    ``run_cap`` with a cap), the ``run`` of :func:`dot_only_run`, and
    ``stride``: when the blocks of a query tile can be trimmed to a
    multiple of 2 parts at no cost in rounds of units (and no set's sum
    over a block's units can overflow), block c's units share their lane
    half and part, their supers ``stride`` apart, and its runs go on across
    them (``ctas_per_qt`` is then the trimmed count); else 0."""
    max_parts = max(_SUPER // run_cap, 1) if run_cap else _S_MAX_PARTS
    plan = _stream_grid(b_pad, n_super, max_parts, sms)
    parts, ctas = plan["parts"], plan["ctas_per_qt"]
    run = dot_only_run(dim, parts, run_cap)
    units, step = n_super * 2 * parts, 2 * parts
    trimmed = ctas // step * step
    stride = 0
    if not run_cap and run == _SUPER // parts and trimmed:
        rounds = -(-units // trimmed)
        if rounds == -(-units // ctas) and rounds * (run // 2) * dim * _S_DOT_MAX <= 2**31 - 1:
            ctas, stride = trimmed, trimmed // step
    return {"parts": parts, "ctas_per_qt": ctas, "run": run, "stride": stride}


def dot_only_runs_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    *,
    parts: int,
    run_cap: int = 0,
    stride: int = 0,
) -> tuple[torch.Tensor, int]:
    """Twin of kernel S's order of adds on the stream: per (super, lane,
    part) the sub-blocks go in runs of :func:`dot_only_run`, or, with
    ``stride`` > 0 (:func:`dot_only_plan`), the whole part over the supers
    s, s + stride, ... that one block walks; within a run the even
    sub-blocks sum into one accumulator set and the odd ones into the other
    (in int64 here), each set's run sum is taken as an int32 register
    holds it (wrapped), and the two go into the output by unsigned adds
    mod 2**32. Returns (the (B_pad, 128) int32 sums, the number of set runs
    whose sum left the int32 range): with the planned runs the count is 0,
    so the sums do not depend on how the tensor cores treat an int32
    overflow."""
    _check_parts(parts, 2)
    b_pad, dim = queries.shape
    run = _SUPER // parts if stride else dot_only_run(dim, parts, run_cap)
    n_super = corpus.shape[0] // _TURBO_UNIT
    # the open runs: (b_pad, runs of a super, set, lane) by super class
    classes = stride or n_super
    sets = torch.zeros((classes, b_pad, _SUPER // run, 2, 128), dtype=torch.int64,
                       device=queries.device)
    for lo, hi, dots in _int8_dot_chunks(queries, corpus):
        # (b_pad, supers, runs, set, lane): sub-block pos = run * r + 2 j + set
        chunk = dots.view(b_pad, hi - lo, _SUPER // run, run // 2, 2, 128).sum(dim=3)
        for i, sup in enumerate(range(lo, hi)):
            sets[sup % classes] += chunk[:, i]
    overflows = int(((sets < -(2**31)) | (sets >= 2**31)).sum())
    total = _wrap_int32(sets).to(torch.int64).sum(dim=(0, 2, 3)) % 2**32
    return _wrap_int32(total), overflows


def dot_only_cells(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    *,
    paired: bool | None = None,
    run_cap: int = 0,
) -> torch.Tensor:
    """Kernel S on CUDA tensors: kernel A's TMA + wgmma stream
    (``csrc/dot_only_tma.cu``, launched as :func:`dot_only_plan` says);
    its plain twin on CPU tensors. Same contract as :func:`dot_only_plain`,
    any D (a multiple of 16).
    ``paired``: blocks in 2-block clusters at an even number of query
    tiles (default ``_S_PAIRED``); ``run_cap`` (0 to 128): see
    :func:`dot_only_run` (0, the default, keeps every int32 sum in
    range)."""
    if not 0 <= run_cap <= _SUPER:
        raise ValueError(f"run_cap must lie in 0 .. {_SUPER}, got {run_cap}")
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return dot_only_plain(queries, corpus)
    _require_cuda(queries, corpus)
    n_super = _check_i8_operands("kernel S", queries, corpus, staged=False)
    b_pad, dim = queries.shape
    out = torch.empty((b_pad, 128), dtype=torch.int32, device=queries.device)
    paired = _S_PAIRED if paired is None else paired
    with torch.cuda.device(queries.device):
        _kernels.launch(
            "oi_dot_only_tma",
            _kernels.ptr(queries), _kernels.ptr(corpus), _kernels.ptr(out),
            b_pad, dim, n_super, int(paired), run_cap, _kernels.stream_of(queries),
        )
    dot_only_cells.launches += 1
    return out


dot_only_cells.launches = 0


def dot_only_cells_v1(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Kernel S's ``mma.sync`` version (``csrc/dot_only.cu``), the control
    of A/B runs; its plain twin on CPU tensors. Same contract as
    :func:`dot_only_plain`; its 32-query tile must fit in shared memory."""
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return dot_only_plain(queries, corpus)
    _require_cuda(queries, corpus)
    n_super = _check_i8_operands("kernel S v1", queries, corpus)
    b_pad, dim = queries.shape
    out = torch.empty((b_pad, 128), dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        _kernels.launch(
            "oi_dot_only",
            _kernels.ptr(queries), _kernels.ptr(corpus), _kernels.ptr(out),
            b_pad, dim, n_super, _kernels.stream_of(queries),
        )
    dot_only_cells_v1.launches += 1
    return out


dot_only_cells_v1.launches = 0


def dot_only(
    corpus: torch.Tensor,  # (N_pad, D) int8 (pad_corpus_rows)
    queries: torch.Tensor,  # (B, D) int8
    plain: bool = False,  # run kernel S's plain twin (verification)
) -> torch.Tensor:
    """The int8 stream-floor probe (the reference's ``dot_only`` of
    ``scripts/bench_kernel_decomp.py``): (B, 128) int32 per-lane sums of
    every dot, wrapping. Kernel A's corpus and mma volume with no fold, so
    its time is the least the int8 candidate stream takes. The batch pads
    to the 32-query tile; the pad rows are dropped. A feature width that
    is not a multiple of 16 is zero-padded here (:func:`pad_features`), a
    copy of the corpus per call."""
    corpus = pad_features(corpus)  # a copy per call unless padded at load
    queries = pad_features(queries, corpus.shape[1])
    if corpus.shape[0] % _TURBO_UNIT or corpus.shape[0] < _TURBO_UNIT:
        corpus = pad_corpus_rows(corpus)
    b = queries.shape[0]
    q = _pad_query_rows(queries, _I8_QUERY_TILE).contiguous()
    return (dot_only_plain if plain else dot_only_cells)(q, corpus)[:b]


# ---------------------------------------------------------------------------
# Kernel D: f32/bf16 candidate cells, top-1 key per (query, super, lane).
# ---------------------------------------------------------------------------


def fast_cells_plain(
    queries: torch.Tensor,  # (B_pad, D) f32 or bf16, B_pad a multiple of 32
    corpus: torch.Tensor,  # (N_pad, D) same dtype, N_pad a multiple of 16,384
) -> torch.Tensor:
    """Plain twin of kernel D. Returns (B_pad, n_super * 128) int32: column
    s * 128 + lane holds the max over pos in [0, 128) of

        key = (bits_i32(dot(q, doc s * 16384 + pos * 128 + lane) + 2.0) & ~127) | pos

    (signed int32 max; each of a cell's 128 keys carries its own pos, so
    the max is unique). The dots run as a float32 product with TF32 off;
    bf16 operands widen exactly, so their products are exact."""
    require_true_f32()
    b_pad = queries.shape[0]
    n_super = corpus.shape[0] // _TURBO_UNIT
    dev = queries.device
    qf = queries.float()
    out = torch.empty((b_pad, n_super * 128), dtype=torch.int32, device=dev)
    pos = torch.arange(_SUPER, dtype=torch.int32, device=dev)[None, None, :, None]
    for lo in range(0, n_super, _TWIN_CHUNK_SUPERS):
        hi = min(lo + _TWIN_CHUNK_SUPERS, n_super)
        docs = corpus[lo * _TURBO_UNIT : hi * _TURBO_UNIT].float()
        bits = (qf @ docs.T + _SHIFT).view(torch.int32)
        keys = (bits.view(b_pad, hi - lo, _SUPER, 128) & ~_POS_MASK) | pos
        out[:, lo * 128 : hi * 128] = keys.amax(dim=2).view(b_pad, -1)
    return out


def _check_fast_operands(name, queries, corpus, *, staged: bool) -> int:
    """Kernel D's operands (both versions); returns n_super."""
    if corpus.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes f32 or bf16 rows, got {corpus.dtype}")
    if queries.dtype != corpus.dtype:
        raise TypeError(f"{name} takes queries of the corpus dtype")
    n_pad = corpus.shape[0]
    if n_pad % _TURBO_UNIT or n_pad == 0:
        raise ValueError(f"corpus rows {n_pad} off the 16,384-doc unit")
    row_bytes = queries.shape[1] * corpus.element_size()
    _check_turbo_operands(name, queries, corpus, row_bytes, staged=staged)
    return n_pad // _TURBO_UNIT


def _launch_turbo_f32(queries, corpus, n_super) -> torch.Tensor:
    b_pad, dim = queries.shape
    out = torch.empty((b_pad, n_super * 128), dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        _kernels.launch(
            "oi_turbo_f32",
            _kernels.ptr(queries), _kernels.ptr(corpus), _kernels.ptr(out),
            int(corpus.dtype == torch.bfloat16), b_pad, dim, n_super,
            _kernels.stream_of(queries),
        )
    return out


def fast_cells(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Kernel D on CUDA tensors: bf16 rows through ``csrc/turbo_bf16_tma.cu``
    (TMA + wgmma), f32 rows through the true-f32 FMA kernel of
    ``csrc/turbo_f32.cu``; its plain twin on CPU tensors. Same contract as
    :func:`fast_cells_plain`."""
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return fast_cells_plain(queries, corpus)
    _require_cuda(queries, corpus)
    bf16 = corpus.dtype == torch.bfloat16
    n_super = _check_fast_operands("kernel D", queries, corpus, staged=not bf16)
    if not bf16:
        out = _launch_turbo_f32(queries, corpus, n_super)
    else:
        b_pad, dim = queries.shape
        out = torch.empty((b_pad, n_super * 128), dtype=torch.int32, device=queries.device)
        with torch.cuda.device(queries.device):
            _kernels.launch(
                "oi_turbo_bf16_tma",
                _kernels.ptr(queries), _kernels.ptr(corpus), _kernels.ptr(out),
                b_pad, dim, n_super, _kernels.stream_of(queries),
            )
    fast_cells.launches += 1
    return out


fast_cells.launches = 0


def fast_cells_v1(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Kernel D's ``mma.sync`` version (``csrc/turbo_f32.cu``: bf16
    ``mma.sync``, f32 FMA),
    the control of A/B runs; its plain twin on CPU tensors. Same contract
    as :func:`fast_cells_plain`."""
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return fast_cells_plain(queries, corpus)
    _require_cuda(queries, corpus)
    n_super = _check_fast_operands("kernel D v1", queries, corpus, staged=True)
    out = _launch_turbo_f32(queries, corpus, n_super)
    fast_cells_v1.launches += 1
    return out


fast_cells_v1.launches = 0


def dense_topk_fast(
    corpus: torch.Tensor,  # (N, D) unit-norm rows, f32 or bf16 (pad_corpus_rows)
    queries: torch.Tensor,  # (B, D) unit-norm rows, the corpus dtype
    k: int = 10,
    block_c: int = 8192,
    n_docs: int | None = None,  # true corpus size when the corpus is padded
    plain: bool = False,  # run kernel D's plain twin (verification)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate cosine top-k from kernel D's cells (the reference's
    ``dense_topk_fast``). Returns (vals (B, k) f32, quantised to 2**-16 /
    2**-15, ids (B, k) int32), padded with (0.0, -1); k beyond the capacity
    of 128 per super clamps and pads. Pass :func:`pad_corpus_rows` rows and
    the true ``n_docs``: unpadded rows pay a corpus copy per call, and so
    does a feature width that is not a multiple of 16 (:func:`pad_features`).
    ``block_c`` (a multiple of 128 dividing 16,384) is validated as the
    reference does; the cells do not depend on it."""
    # _TURBO_UNIT is the reference's _SUPER_COLS: docs per super
    if block_c % 128 or _TURBO_UNIT % block_c:
        raise ValueError("block_c must be a multiple of 128 dividing 16384")
    corpus = pad_features(corpus)  # a copy per call unless padded at load
    queries = pad_features(queries, corpus.shape[1])
    n_stored = corpus.shape[0]
    n_docs = n_stored if n_docs is None else n_docs
    b = queries.shape[0]
    if n_stored % _TURBO_UNIT or n_stored < _TURBO_UNIT:
        corpus = pad_corpus_rows(corpus)
    queries = _pad_query_rows(queries, _I8_QUERY_TILE)
    n_super = corpus.shape[0] // _TURBO_UNIT
    k_req = k
    k = min(k, n_super * 128)
    packed = (fast_cells_plain if plain else fast_cells)(queries.contiguous(), corpus)
    # the reference's over-fetch: 128 slots where zero-padding may shadow
    # negative-scored docs of a small corpus, else the 32-slot margin
    padded = corpus.shape[0] != n_docs
    pad_slots = 128 if (padded and n_docs <= 262_144) else 0
    k_fetch = min(k + max(pad_slots, 32), n_super * 128)

    def decode(pvals, pcols):
        pos = pvals & _POS_MASK  # sub-block within the super
        ids = (((pcols // 128) * 128 + pos) * 128 + pcols % 128).to(torch.int32)
        vals = (pvals & ~_POS_MASK).view(torch.float32) - _SHIFT
        return ids, vals, ids < n_docs  # zero-padding decodes past n_docs

    vals, ids, valid = _select_and_compact(packed, k, k_fetch, decode)
    return _finish(vals, ids, valid, b, k_req)


# ---------------------------------------------------------------------------
# Kernels E1/E2: int8 query x nibble-packed int4 corpus, top-1 or top-2 keys
# per (query, super, lane).
# ---------------------------------------------------------------------------


def _i4_key_chunks(queries: torch.Tensor, corpus: torch.Tensor):
    """Kernels E's keys, a few supers at a time: yields (lo, hi, keys) with
    keys (B_pad, hi - lo, 128 pos, 128 lanes) int32 for supers lo .. hi - 1.
    The dots run as a float32 product with TF32 off: every partial sum is
    an integer below 2**24."""
    require_true_f32()
    b_pad = queries.shape[0]
    unit_b = _TURBO_UNIT // 2
    n_super = corpus.shape[0] // unit_b
    qf = queries.float()
    pos = (_I8_FLAG128 + torch.arange(_SUPER, dtype=torch.int32, device=queries.device))
    pos = pos[None, None, :, None]
    for lo in range(0, n_super, _TWIN_CHUNK_SUPERS):
        hi = min(lo + _TWIN_CHUNK_SUPERS, n_super)
        v = corpus[lo * unit_b : hi * unit_b].to(torch.int32)
        # sign-extended nibbles (the reference's (v << 28) >> 28, (v << 24) >> 28)
        nibbles = (((v & 15) ^ 8) - 8, v >> 4)
        dots = torch.stack(
            [(qf @ x.float().T).view(b_pad, hi - lo, _I4_SUPER_B, 128) for x in nibbles],
            dim=3,
        ).to(torch.int32)  # (b_pad, supers, byte_tile, parity, lane)
        yield lo, hi, dots.view(b_pad, hi - lo, _SUPER, 128) * 128 + pos


def i4_cells_plain(
    queries: torch.Tensor,  # (B_pad, D) int8, B_pad a multiple of 32
    corpus: torch.Tensor,  # (N_pad / 2, D) packed bytes (pack_corpus_i4)
    *,
    slots: int,
) -> torch.Tensor:
    """Plain twin of kernels E1 (``slots=1``) and E2 (``slots=2``). Returns
    (B_pad, slots * n_super * 128) int32: column s * 128 + lane of slot j's
    half holds the j-th largest over the super's 128 keys of its lane,

        key = dot * 128 + _I8_FLAG128 + pos,  pos = 2 * byte_tile + parity,

    for doc s * 16384 + 2 * (byte_tile * 128 + lane) + parity. A cell's keys
    are distinct, so its top-2 is unique."""
    n_super = corpus.shape[0] // (_TURBO_UNIT // 2)
    return _part_tops(_i4_key_chunks(queries, corpus), queries, n_super, slots, 1)[0]


def i4_part_cells_plain(
    queries: torch.Tensor, corpus: torch.Tensor, *, slots: int, parts: int
) -> torch.Tensor:
    """Plain twin of kernels E's parts before they meet (``csrc/turbo_i4_tma.cu``
    splits each super's 128 sub-blocks into ``parts`` runs of 128 / parts).
    Returns (parts, B_pad, slots * n_super * 128) int32: buffer p holds, in
    :func:`i4_cells_plain`'s layout, the top ``slots`` keys of each cell
    over pos in [p * 128 / parts, (p + 1) * 128 / parts)."""
    _check_parts(parts, slots)
    n_super = corpus.shape[0] // (_TURBO_UNIT // 2)
    return _part_tops(_i4_key_chunks(queries, corpus), queries, n_super, slots, parts)


def merge_part_cells_plain(part_cells: torch.Tensor, *, slots: int) -> torch.Tensor:
    """Plain twin of where kernels C's and E's parts meet: the cells of
    :func:`i8_turbo_part_cells_plain`'s or :func:`i4_part_cells_plain`'s
    buffers (disjoint key sets) merged into the whole cells. Slots 1 take
    the max (``atomicMax``); slots 2 fold the buffers in order by the
    reference's combine, ``a2 = max(min(a1, b1), max(a2, b2))``
    (``merge_top2`` of ``csrc/tma_stream.cuh``), exact for distinct keys,
    so the order does not matter."""
    if slots == 1:
        return part_cells.amax(dim=0)
    half = part_cells.shape[2] // 2
    a1, a2 = part_cells[0, :, :half], part_cells[0, :, half:]
    for cells in part_cells[1:]:
        b1, b2 = cells[:, :half], cells[:, half:]
        a2 = torch.maximum(torch.minimum(a1, b1), torch.maximum(a2, b2))
        a1 = torch.maximum(a1, b1)
    return torch.cat([a1, a2], dim=1)


def _check_i4_operands(name, queries, corpus, *, staged: bool) -> int:
    """Kernels E's operands (both versions); returns n_super. ``staged``:
    the 32-query tile of the ``mma.sync`` kernel sits whole in shared
    memory."""
    if queries.dtype != torch.int8 or corpus.dtype != torch.int8:
        raise TypeError(f"{name} take int8 queries and a packed int8 corpus")
    dim = queries.shape[1]
    n_packed = corpus.shape[0]
    if n_packed % (_TURBO_UNIT // 2) or n_packed == 0 or dim >= _I4_DIM_LIMIT:
        raise ValueError(
            f"{name}: {n_packed} byte rows off the 8,192-row unit, or "
            f"D={dim} not below {_I4_DIM_LIMIT}"
        )
    _check_turbo_operands(name, queries, corpus, dim, staged=staged)
    return n_packed // (_TURBO_UNIT // 2)


def i4_cells(
    queries: torch.Tensor, corpus: torch.Tensor, *, slots: int, max_parts: int | None = None
) -> torch.Tensor:
    """Kernel E1 (``slots=1``) or E2 (``slots=2``) on CUDA tensors: TMA, an
    unpack in shared memory and wgmma (``csrc/turbo_i4_tma.cu``); their
    plain twin on CPU tensors. Same contract as :func:`i4_cells_plain`.
    ``max_parts`` caps the parts a super is split into for an even spread
    over the SMs (default ``_MAX_PARTS``); the cells do not depend on it.
    ``launches`` counts each slot count apart."""
    if slots not in (1, 2):
        raise ValueError(f"slots must be 1 or 2, got {slots}")
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return i4_cells_plain(queries, corpus, slots=slots)
    _require_cuda(queries, corpus)
    n_super = _check_i4_operands("kernels E", queries, corpus, staged=False)
    out = _launch_cells("oi_turbo_i4_tma", queries, corpus, n_super, slots, max_parts)
    i4_cells.launches[slots] += 1
    return out


i4_cells.launches = {1: 0, 2: 0}


def i4_cells_v1(queries: torch.Tensor, corpus: torch.Tensor, *, slots: int) -> torch.Tensor:
    """Kernels E's ``mma.sync`` version (``csrc/turbo_i4.cu``), the control
    of A/B runs; its plain twin on CPU tensors. Same contract as
    :func:`i4_cells_plain`."""
    if slots not in (1, 2):
        raise ValueError(f"slots must be 1 or 2, got {slots}")
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return i4_cells_plain(queries, corpus, slots=slots)
    _require_cuda(queries, corpus)
    n_super = _check_i4_operands("kernels E v1", queries, corpus, staged=True)
    out = _launch_cells_v1("oi_turbo_i4", queries, corpus, n_super, slots)
    i4_cells_v1.launches[slots] += 1
    return out


i4_cells_v1.launches = {1: 0, 2: 0}


def dense_topk_fast_i4(
    corpus: torch.Tensor,  # (N_pad / 2, D) nibble-packed bytes (pack_corpus_i4)
    queries: torch.Tensor,  # (B, D) int8 quantised unit-norm rows (scale 127)
    k: int = 10,
    block_c: int = 4096,  # byte rows per reference grid step
    n_docs: int | None = None,
    slots: int = 2,
    scale: float = _I4_SCALE_DEFAULT,
    plain: bool = False,  # run the kernels' plain twin (verification)
) -> tuple[torch.Tensor, torch.Tensor]:
    """int4 approximate cosine top-k (the reference's ``dense_topk_fast_i4``):
    kernel E1/E2's cells, then the decode. Returns (vals (B, k) f32, ids
    (B, k) int32), padded with (0.0, -1); k beyond the capacity of
    128 * slots per super clamps and pads. Callers pass their candidate
    width as k and rescore exactly. ``block_c`` (a multiple of 128 dividing
    8,192) is validated as the reference does; the cells do not depend on
    it. A feature width that is not a multiple of 16 is zero-padded here
    (:func:`pad_features`), a copy of the corpus per call: the retrievers
    pad theirs once at load."""
    if corpus.dtype != torch.int8 or queries.dtype != torch.int8:
        raise TypeError("dense_topk_fast_i4 takes int8 operands")
    if slots not in (1, 2):
        raise ValueError(f"slots must be 1 or 2, got {slots}")
    # a copy per call unless padded at load; zero bytes hold zero nibbles
    corpus = pad_features(corpus)
    queries = pad_features(queries, corpus.shape[1])
    n_packed = corpus.shape[0]
    n_stored = 2 * n_packed
    n_docs = n_stored if n_docs is None else n_docs
    b = queries.shape[0]
    unit_b = _TURBO_UNIT // 2
    if block_c % 128 or unit_b % block_c:
        raise ValueError("block_c must be a multiple of 128 dividing 8192")
    if n_packed % unit_b or n_packed < unit_b:
        raise ValueError("pack the corpus with pack_corpus_i4 (pads to the unit)")
    queries = _pad_query_rows(queries, _I8_QUERY_TILE)
    n_super = n_stored // _TURBO_UNIT
    lanes = 128 * slots
    k_req = k
    k = min(k, n_super * lanes)
    half = n_super * 128
    cells = i4_cells_plain if plain else i4_cells
    packed = cells(queries.contiguous(), corpus, slots=slots)
    padded = n_stored != n_docs
    pad_slots = lanes if (padded and n_docs <= 262_144) else 0
    k_fetch = min(k + max(pad_slots, 32), n_super * lanes)
    # XLA folds the reference's "/ (127 * scale)" into a multiply by the
    # float32 reciprocal; the same multiply keeps the values bit-identical
    inv = float(np.float32(1.0) / np.float32(127.0 * scale))

    def decode(pvals, pcols):
        pos = pvals & 127  # 2 * byte_tile + parity within the super
        col = pcols % half  # both slot halves decode alike
        ids = (
            (col // 128) * _TURBO_UNIT + (pos >> 1) * 256 + 2 * (col % 128) + (pos & 1)
        ).to(torch.int32)
        vals = ((pvals - pos - _I8_FLAG128) // 128).float() * inv
        return ids, vals, (ids < n_docs) & (pvals > 0)

    vals, ids, valid = _select_and_compact(packed, k, k_fetch, decode)
    return _finish(vals, ids, valid, b, k_req)


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
    return _pad_columns(vals, ids, k)


def _check_fused_operands(name, doc_emb, queries, k) -> None:
    if doc_emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes f32 or bf16 rows, got {doc_emb.dtype}")
    if queries.dtype != doc_emb.dtype:
        raise TypeError(f"{name} takes queries of the corpus dtype")
    if queries.shape[1] != doc_emb.shape[1] or not 1 <= k <= _FUSED_MAX_K or doc_emb.shape[0] < 1:
        raise ValueError(
            f"{name}: queries {tuple(queries.shape)}, corpus "
            f"{tuple(doc_emb.shape)}, k={k} (1 <= k <= {_FUSED_MAX_K})"
        )


def _mask_unfilled(out_vals, out_ids):
    unfilled = out_ids < 0
    return (
        torch.where(unfilled, torch.zeros_like(out_vals), out_vals),
        torch.where(unfilled, torch.full_like(out_ids, -1), out_ids),
    )


def fused_plan(b: int, n_docs: int, k: int, sms: int = 132) -> dict:
    """Kernel B v2's launch geometry (``csrc/fused_topk_v2.cu``): the query
    tile (64 rows, or 16 at a batch of 16 or fewer and at k > 32, whose
    lists do not fit 64 rows' shared memory; doc tiles of 128), the corpus
    splits (enough for ``_FUSED_BLOCKS_PER_SM`` blocks on each of ``sms``
    SMs, at most one per doc tile; ``split_len`` whole doc tiles),
    where each row's list lives, the candidate buffer ``cap`` and the sort
    width ``sort_len`` (a power of two). While a block's rows of
    ``sort_len`` slots fit in ``_FUSED_LIST_SMEM`` bytes (k <= 224 at 16
    rows, k <= 32 at 64), list and buffer share them in shared memory
    (``cap = sort_len - k``, sort_len the power of two >= k + 32); else the
    lists live in device memory, with a 64-slot buffer. Each split's lists
    are merged 32 at a time, in passes, so the split count has no cap."""
    qt = 64 if b > 16 and k <= _FUSED_MIN_CAP else 16
    nt = _FUSED_TILE_DOCS
    n_qt = -(-b // qt)
    n_tiles = -(-n_docs // nt)
    want = max(1, -(-(_FUSED_BLOCKS_PER_SM[qt] * sms) // n_qt))
    per_split = -(-n_tiles // min(want, n_tiles))
    split_len = per_split * nt
    n_split = -(-n_docs // split_len)
    sort_len = 1 << (k + _FUSED_MIN_CAP - 1).bit_length()
    list_in_smem = qt * sort_len * 8 <= _FUSED_LIST_SMEM
    if not list_in_smem:
        sort_len = 1 << (k + _FUSED_CAP - 1).bit_length()
    return {
        "qt": qt, "nt": nt, "n_split": n_split, "split_len": split_len,
        "cap": sort_len - k if list_in_smem else _FUSED_CAP,
        "sort_len": sort_len, "list_in_smem": int(list_in_smem),
    }


def fused_stream_plan(b: int, n_docs: int, sms: int = 132) -> dict:
    """Kernel B's stream route (bf16 rows, k <= 32) as ``plan_grid`` of
    ``csrc/tma_stream.cuh`` lays out its grid: ``n_super`` 16,384-doc
    supers, each split into ``parts`` (the fewest, a power of two up to 16,
    that spread the units of (super, lane half, part) over the SMs at >=
    90 %, else the most even split), walked by ``ctas_per_qt`` blocks per
    128-query tile: block c takes units c, c + ctas_per_qt, ... Each block
    leaves one list per query, so a query gets ``ctas_per_qt`` lists (the
    kernel refuses a count that differs from its own plan)."""
    n_super = -(-n_docs // _TURBO_UNIT)
    return {"n_super": n_super, **_stream_grid(b, n_super, _STREAM_MAX_PARTS, sms)}


def _stream_grid(b: int, n_super: int, max_parts: int, sms: int) -> dict:
    """``plan_grid`` of ``csrc/tma_stream.cuh``: the parts a super is split
    into and the blocks per 128-query tile."""
    per_qt = max(sms // -(-b // _STREAM_QUERY_ROWS), 1)
    best, plan = -1.0, {}
    parts = 1
    while parts <= min(max_parts, _STREAM_MAX_PARTS):
        units = n_super * 2 * parts
        c = min(units, per_qt)
        eff = units / (-(-units // c) * per_qt)
        if eff > best + 1e-9:
            best, plan = eff, {"parts": parts, "ctas_per_qt": c}
        if eff >= 0.9:
            break
        parts *= 2
    return plan


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def fused_topk(
    doc_emb: torch.Tensor, queries: torch.Tensor, k: int, *, route: str = "ring"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B (``csrc/fused_topk_v2.cu``) on CUDA tensors; its plain twin
    on CPU tensors. Same contract as :func:`fused_topk_plain`, for any D
    and any k <= 1,024. A D that is not a multiple of 16 is zero-padded
    here, which copies the corpus on every call: the retrievers pad their
    rows once at load (:func:`pad_features`).

    ``route``: ``"ring"`` (served) runs the ``cp.async`` ring kernel;
    ``"stream"`` runs bf16 rows at k <= 32 on the TMA + wgmma stream
    instead, which measured slower on an H100 (its selection holds the
    wgmma warps; ``PERF.md`` §6) and is kept as the ring's A/B
    measurement."""
    if doc_emb.device.type == "cpu" and queries.device.type == "cpu":
        return fused_topk_plain(doc_emb, queries, k)
    _require_cuda(doc_emb, queries)
    _check_fused_operands("kernel B", doc_emb, queries, k)
    stream = route == "stream"
    if route not in ("ring", "stream") or (
        stream and (doc_emb.dtype != torch.bfloat16 or k > _FUSED_STREAM_MAX_K)
    ):
        raise ValueError(
            f"route={route!r}: 'ring', or 'stream' for bf16 rows at k <= "
            f"{_FUSED_STREAM_MAX_K} (got {doc_emb.dtype}, k={k})"
        )
    doc_emb = pad_features(doc_emb).contiguous()
    queries = pad_features(queries, doc_emb.shape[1]).contiguous()
    n_docs, dim = doc_emb.shape
    b = queries.shape[0]
    dev = queries.device
    out = torch.empty((2, b, k), dtype=torch.int32, device=dev)  # vals' bits, ids
    if b == 0:
        return out[0].view(torch.float32), out[1]
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if stream:
        n_split = fused_stream_plan(b, n_docs, _sm_count(index))["ctas_per_qt"]
    else:
        plan = fused_plan(b, n_docs, k, _sm_count(index))
        n_split = plan["n_split"]
    n_lists = n_split + (-(-n_split // 32) if n_split > 32 else 0)
    # (vals' bits, ids) of each split's lists, then of the merge passes'
    # lists; then the threshold the splits share per query
    scratch = torch.empty((2 * n_lists * k + 1) * b, dtype=torch.int32, device=dev)
    size = 4 * b * k  # bytes of one list set
    lists = (
        _kernels.ptr(scratch, 2 * n_lists * size),
        _kernels.ptr(scratch), _kernels.ptr(scratch, n_lists * size),
        _kernels.ptr(scratch, n_split * size),
        _kernels.ptr(scratch, (n_lists + n_split) * size),
        _kernels.ptr(out), _kernels.ptr(out, size),
    )
    with torch.cuda.device(dev):
        if stream:
            _kernels.launch(
                "oi_fused_topk_v2_tma", _kernels.ptr(queries), _kernels.ptr(doc_emb),
                *lists, b, n_docs, dim, k, n_split, _kernels.stream_of(queries),
            )
        else:
            _kernels.launch(
                "oi_fused_topk_v2", _kernels.ptr(queries), _kernels.ptr(doc_emb),
                int(doc_emb.dtype == torch.bfloat16), *lists,
                b, n_docs, dim, k, plan["qt"], n_split, plan["split_len"],
                plan["cap"], plan["sort_len"], plan["list_in_smem"],
                _kernels.stream_of(queries),
            )
    fused_topk.launches += 1
    return out[0].view(torch.float32), out[1]


fused_topk.launches = 0


def fused_topk_v1(
    doc_emb: torch.Tensor, queries: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B's first version (``csrc/fused_topk.cu``: 8 queries and a
    32-doc chunk of whole rows per block in shared memory, at most 32
    splits), the control of A/B runs; its plain twin on CPU tensors. Same
    contract as :func:`fused_topk_plain`, within its shared memory."""
    if doc_emb.device.type == "cpu" and queries.device.type == "cpu":
        return fused_topk_plain(doc_emb, queries, k)
    _require_cuda(doc_emb, queries)
    _check_fused_operands("kernel B v1", doc_emb, queries, k)
    n_docs, dim = doc_emb.shape
    b = queries.shape[0]
    if 4 * (8 * dim + 32 * (dim + 1) + 16 * k) > _SMEM_LIMIT:
        raise ValueError(f"D={dim}, k={k} exceed kernel B v1's shared memory")
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
    fused_topk_v1.launches += 1
    return _mask_unfilled(out_vals, out_ids)


fused_topk_v1.launches = 0


def dense_topk_pallas(
    doc_emb: torch.Tensor,  # (N, D) unit-norm rows, f32 or bf16
    queries: torch.Tensor,  # (B, D) unit-norm rows, same dtype as doc_emb
    k: int = 10,
    plain: bool = False,  # run kernel B's plain twin (verification)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused cosine top-k (the reference's ``dense_topk_pallas``). Returns
    (vals (B, k) f32, ids (B, k) int32); k > n_docs leaves (0.0, -1)
    slots. Queries narrower than the rows (rows padded by
    :func:`pad_features`) are zero-padded to match; a D that is not a
    multiple of 16 costs a per-call copy of the corpus on the card."""
    if k > _FUSED_MAX_K:
        raise ValueError(f"k={k} exceeds the fused kernel's {_FUSED_MAX_K}")
    queries = pad_features(queries, doc_emb.shape[1])
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
    i8_top2g_cells_v1.launches = 0
    i8_fold_steps.launches = 0
    fused_topk.launches = 0
    fused_topk_v1.launches = 0
    fast_cells.launches = 0
    fast_cells_v1.launches = 0
    i4_cells.launches = {1: 0, 2: 0}
    i4_cells_v1.launches = {1: 0, 2: 0}
    i8_turbo_cells.launches = {1: 0, 2: 0}
    i8_turbo_cells_v1.launches = {1: 0, 2: 0}
    dot_only_cells.launches = 0
    dot_only_cells_v1.launches = 0


def launch_counts() -> dict[str, int]:
    """Launches per kernel since the last reset (``*_v1``: the A/B controls;
    ``i8_fold``: kernel A's second stage launched alone)."""
    return {
        "i8_top2g": i8_top2g_cells.launches,
        "i8_top2g_v1": i8_top2g_cells_v1.launches,
        "i8_fold": i8_fold_steps.launches,
        "fused_topk": fused_topk.launches,
        "fused_topk_v1": fused_topk_v1.launches,
        "turbo_f32": fast_cells.launches,
        "turbo_f32_v1": fast_cells_v1.launches,
        "turbo_i4": i4_cells.launches[1],
        "turbo_i4_top2": i4_cells.launches[2],
        "turbo_i4_v1": i4_cells_v1.launches[1],
        "turbo_i4_top2_v1": i4_cells_v1.launches[2],
        "turbo_i8": i8_turbo_cells.launches[1],
        "turbo_i8_top2": i8_turbo_cells.launches[2],
        "turbo_i8_v1": i8_turbo_cells_v1.launches[1],
        "turbo_i8_top2_v1": i8_turbo_cells_v1.launches[2],
        "dot_only": dot_only_cells.launches,
        "dot_only_v1": dot_only_cells_v1.launches,
    }
