"""Tensor parallelism of the encoder over a ("data", "corpus") mesh.

The reference has no module like this one: it lays the encoder's params
out with ``NamedSharding``s of ``param_partition_specs`` and XLA derives
the collectives (``openintel_tpu/models/encoder.py``, ``train.py``). Here
they are torch ops, run by one process over the mesh's cells (a
single-controller mesh, as the reference's training mesh is):

- **Masters.** Each replicated leaf (the embeddings, every layer norm) is
  one tensor on the mesh's home device; each leaf split over the model
  axis ("corpus", M shards) is one tensor per shard m, on cell (0, m).
  ``proj``'s rows, ``fc1``'s columns and ``fc2``'s rows split into M
  contiguous blocks. ``qkv`` splits **by head**: its (dim, 3·dim) product
  is read as (3, heads, head_dim) columns, so the contiguous blocks of
  ``P(None, model)`` would cut across q, k and v; shard m holds the
  columns ``t·dim + [m·dim/M, (m+1)·dim/M)`` for t = 0, 1, 2, whole heads
  of q, k and v. Gathered, every leaf is the reference's array in its
  column order (:func:`gather_leaf` inverts :func:`shard_leaf`).
- **Forward.** The batch's rows split over the data axis (row d takes
  rows ``[d·N/D, (d+1)·N/D)``, as ``P("data", None)`` does). The
  embeddings are looked up on the home device for the whole batch and each
  row's block moved to cell (d, 0). Per block, the layer norm runs on that
  device; its output is copied to the row's M cells; each cell runs the
  column-parallel ``qkv``, attention over its own heads and its partial
  ``o @ proj`` (row-parallel); the M partials are summed on cell (d, 0)
  in the order m = 0..M-1 (the all-reduce), and the MLP likewise. The
  final norm and pooling run on cell (d, 0), and the rows' embeddings are
  gathered on the home device in row order. The arithmetic is
  ``models.encoder``'s sublayers (tanh GELU, biased variance with eps
  1e-6, -1e9 masked keys, f32 scores under ``dtype="bfloat16"``).
- **Backward.** Autograd. A copy to several cells (:class:`_Spread`) sums
  the copies' gradients on its source device in cell order, and each
  master is spread once a forward, so its gradient is the sum of every
  cell's contribution to the one loss, in a fixed order: reruns are
  bit-identical. The copies and sums run under the profiler labels
  ``tp.spread`` and ``tp.sum``.

A mesh whose cells share one device (``make_mesh(devices=[card] * 4)``)
runs the cells one after another; it shows what the split costs, not a
speed-up.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn
from torch.profiler import record_function

from openintel_tpu_torch.models.encoder import (
    Encoder,
    EncoderConfig,
    attention,
    contrastive_loss,
    embed,
    mlp,
    nest,
    pool,
    _ln,
)
from openintel_tpu_torch.ops.dense import require_true_f32
from openintel_tpu_torch.parallel.mesh import CORPUS_AXIS, DATA_AXIS, Mesh

COLUMNS, ROWS = ("fc1",), ("proj", "fc2")  # contiguous splits; qkv splits by head


def _leaf_name(key: str) -> str:
    return key.replace("/", ".").rsplit(".", 1)[-1]


def shard_leaf(key: str, value: torch.Tensor, parts: int) -> tuple:
    """One leaf of the params layout (``key`` its dotted or slashed path)
    cut into its ``parts`` shards over the model axis, each a new tensor;
    a replicated leaf is a 1-tuple."""
    name = _leaf_name(key)
    if name == "qkv":
        dim = value.shape[0]
        w = dim // parts
        return tuple(
            torch.cat([value[:, t * dim + m * w : t * dim + (m + 1) * w] for t in range(3)], dim=1)
            for m in range(parts)
        )
    if name in COLUMNS:
        return tuple(s.clone() for s in value.chunk(parts, dim=1))
    if name in ROWS:
        return tuple(s.clone() for s in value.chunk(parts, dim=0))
    return (value.clone(),)


def gather_leaf(key: str, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The inverse of :func:`shard_leaf`: the full array, in the
    reference's column order, on the first shard's device."""
    home = shards[0].device
    shards = [s.to(home) for s in shards]
    name = _leaf_name(key)
    if name == "qkv":
        w = shards[0].shape[1] // 3
        return torch.cat([s[:, t * w : (t + 1) * w] for t in range(3) for s in shards], dim=1)
    if name in COLUMNS:
        return torch.cat(shards, dim=1)
    if name in ROWS:
        return torch.cat(shards, dim=0)
    return shards[0].clone()


def _map_leaves(tree, fn: Callable, key: str = ""):
    """``tree`` in the params layout with each leaf (an array, or a tuple
    of shards) replaced by ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, f"{key}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn, f"{key}{i}/") for i, v in enumerate(tree)]
    return fn(key[:-1], tree)


def shard_tree(tree, parts: int):
    """A tree in the params layout (params, or AdamW's moments) with each
    leaf cut into the tuple of its shards."""
    return _map_leaves(tree, lambda key, a: shard_leaf(key, torch.as_tensor(a), parts))


def gather_tree(tree):
    """The inverse of :func:`shard_tree`."""
    return _map_leaves(tree, gather_leaf)


class _Spread(torch.autograd.Function):
    """A tensor copied to each of ``devices``; the backward sums the
    copies' gradients on the source device in the order of ``devices``."""

    @staticmethod
    def forward(ctx, src, devices):
        ctx.device = src.device
        with record_function("tp.spread"):
            return tuple(src.to(d, copy=True) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        with record_function("tp.spread"):
            total = grads[0].to(ctx.device, copy=True)
            for g in grads[1:]:
                total += g.to(ctx.device)
        return total, None


def spread(src: torch.Tensor, devices) -> tuple:
    return _Spread.apply(src, list(devices))


def reduce_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The partials of a row-parallel product summed on ``device`` in
    order (their backward hands each partial the same gradient)."""
    with record_function("tp.sum"):
        total = parts[0].to(device)
        for p in parts[1:]:
            total = total + p.to(device)
    return total


class ShardedEncoder:
    """The encoder's weights as masters on a mesh (the module docstring's
    layout): ``masters`` is a tree in the params layout whose leaves are
    tuples of ``nn.Parameter`` (one for a replicated leaf, M for a split
    one). Calling it encodes a batch tensor-parallel."""

    def __init__(self, cfg: EncoderConfig, mesh: Mesh, masters: dict):
        self.cfg, self.mesh, self.masters = cfg, mesh, masters

    @property
    def parts(self) -> int:
        return self.mesh.shape[CORPUS_AXIS]

    @property
    def rows(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    def named_masters(self):
        """(key, shard index, master) of every master, in the params
        layout's order."""
        out = []
        _map_leaves(self.masters, lambda key, ps: out.extend((key, m, p) for m, p in enumerate(ps)))
        return out

    def parameters(self):
        return [p for _, _, p in self.named_masters()]

    def tree(self, leaf=lambda p: p.detach()) -> dict:
        """The gathered tree in the params layout, each leaf the full array
        of ``leaf(master)`` over its shards, on the home device (shard 0's)."""
        return _map_leaves(self.masters, lambda key, ps: gather_leaf(key, [leaf(p) for p in ps]))

    def _copies(self) -> dict:
        """Each master spread to the cells that use it, indexed [m][d]: a
        split leaf's shard m to cells (d, m), a replicated layer norm to
        cells (d, 0). The embeddings stay on the home device."""
        mesh = self.mesh

        def copies(key, shards):
            if key in ("tok_emb", "pos_emb"):
                return shards
            return tuple(
                spread(p, [mesh.device(d, m) for d in range(self.rows)]) for m, p in enumerate(shards)
            )

        return _map_leaves(self.masters, copies)

    def __call__(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(N, S) ids + bool mask -> (N, dim) unit-norm f32 embeddings on the
        home device, the rows split over the data axis."""
        cfg, mesh, home = self.cfg, self.mesh, self.mesh.home
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        if any(mesh.device(d, m).type == "cuda" for d in range(self.rows) for m in range(self.parts)):
            require_true_f32()
        w = self._copies()
        x = embed(w["tok_emb"][0], w["pos_emb"][0], ids.to(home), dtype)
        xs, masks = x.tensor_split(self.rows), mask.to(home).tensor_split(self.rows)
        out = [self._row(w, d, xs[d], masks[d], dtype) for d in range(self.rows)]
        with record_function("tp.sum"):
            return torch.cat([e.to(home) for e in out])

    def _row(self, w: dict, d: int, x, mask, dtype) -> torch.Tensor:
        cfg, parts = self.cfg, self.parts
        cells = [self.mesh.device(d, m) for m in range(parts)]
        x, masks = x.to(cells[0]), [mask.to(c) for c in cells]
        heads = cfg.heads // parts
        for blk in w["blocks"]:
            ys = spread(_ln(x, blk["ln1"]["g"][0][d], blk["ln1"]["b"][0][d], dtype), cells)
            x = x + reduce_sum([
                attention(ys[m], masks[m], blk["qkv"][m][d], blk["proj"][m][d], heads, cfg.head_dim, dtype)
                for m in range(parts)
            ], cells[0])
            ys = spread(_ln(x, blk["ln2"]["g"][0][d], blk["ln2"]["b"][0][d], dtype), cells)
            x = x + reduce_sum(
                [mlp(ys[m], blk["fc1"][m][d], blk["fc2"][m][d], dtype) for m in range(parts)], cells[0]
            )
        return pool(x, masks[0], w["ln_f"]["g"][0][d], w["ln_f"]["b"][0][d])


def check_mesh(cfg: EncoderConfig, mesh: Mesh) -> None:
    """The reference's refusal of a model axis that does not divide the
    heads (and so every split leaf), and a refusal of a mesh that spans
    processes."""
    parts = mesh.shape[CORPUS_AXIS]
    if cfg.heads % parts or (4 * cfg.dim) % parts:
        raise ValueError(
            f"model axis {parts} must divide heads ({cfg.heads}) and 4*dim ({4 * cfg.dim})"
        )
    if mesh.world > 1:
        raise ValueError(
            f"the encoder trains over a mesh in one process; this mesh spans {mesh.world} "
            "processes (the reference has no multi-process training either)"
        )


def shard_encoder(model: Encoder, mesh: Mesh) -> ShardedEncoder:
    """``model``'s weights cut into masters on ``mesh`` (copies: ``model``
    is left as it is)."""
    check_mesh(model.cfg, mesh)
    shards = shard_tree(
        nest(((n, p.detach()) for n, p in model.named_parameters()), model.cfg.depth), mesh.shape[CORPUS_AXIS]
    )

    def masters(key, parts):
        if len(parts) == 1:
            return (nn.Parameter(parts[0].to(mesh.home, copy=True)),)
        return tuple(nn.Parameter(s.to(mesh.device(0, m), copy=True)) for m, s in enumerate(parts))

    return ShardedEncoder(model.cfg, mesh, _map_leaves(shards, masters))


def gather_encoder(sharded: ShardedEncoder, device=None) -> Encoder:
    """The masters put back together as an ``Encoder`` on ``device`` (the
    mesh's home device by default)."""
    model = Encoder(sharded.cfg, device=sharded.mesh.home if device is None else device)
    named = dict(model.named_parameters())

    def put(key, shards):
        named[key.replace("/", ".")].copy_(gather_leaf(key, [p.detach() for p in shards]))

    with torch.no_grad():
        _map_leaves(sharded.masters, put)
    return model


def flat_leaves(tree) -> dict:
    """{slashed key: leaf} of a tree in the params layout (a leaf may be a
    tuple of shards)."""
    out = {}
    _map_leaves(tree, out.__setitem__)
    return out


def info_nce_loss(sharded: ShardedEncoder, q_ids, q_mask, d_ids, d_mask, temp: float = 0.05) -> torch.Tensor:
    """``models.encoder.info_nce_loss`` over the global batch of B pairs
    (queries and docs padded to one width, as ``make_pairs`` gives them):
    data row d encodes its queries and docs, rows ``[d·B/D, (d+1)·B/D)``
    of each, in one forward, and every row's embeddings are gathered in
    row order before the loss, so each query meets all B docs as
    negatives."""
    rows, b = sharded.rows, q_ids.shape[0]
    ids = torch.cat([t for pair in zip(q_ids.chunk(rows), d_ids.chunk(rows)) for t in pair])
    mask = torch.cat([t for pair in zip(q_mask.chunk(rows), d_mask.chunk(rows)) for t in pair])
    emb = sharded(ids, mask).reshape(rows, 2, b // rows, -1)
    return contrastive_loss(emb[:, 0].reshape(b, -1), emb[:, 1].reshape(b, -1), temp)
