"""Neural text encoder: the port of :mod:`openintel_tpu.models.encoder`.

One trunk for dense retrieval and learned post analysis: a pre-LN
transformer (multi-head attention and a GELU MLP), mean pooling over the
mask and an L2 norm; the InfoNCE contrastive loss (in-batch negatives);
a 2-logit analyzer head distilled from the lexicon analyzer; and
``NeuralEmbedder``, the texts -> (N, dim) callable every retriever takes.

The trunk is an ``nn.Module`` (``Encoder``, its ``blocks`` an
``nn.ModuleList`` of ``Block``) whose weights keep the reference's layout
and names, used as ``x @ W`` (``qkv`` is (dim, 3·dim), ``fc1`` is (dim,
mlp)), so each checkpoint key (``params/blocks/0/qkv``) is one parameter
(``blocks.0.qkv``) with no transpose (``models/checkpoint.py``).

The arithmetic is the reference's, step for step: the tanh form of GELU
(``jax.nn.gelu``'s default), layer norm over the biased variance with eps
1e-6, masked keys set to -1e9 (not -inf), positions sliced to the batch's
width, pooling over ``max(sum(mask), 1)`` and the norm clamped at 1e-6.
Attention is the explicit product, mask, softmax and product, as in the
reference, which has no attention kernel. Under ``dtype="bfloat16"`` the
blocks' weights and the activations are cast to bf16 and follow the
reference's type promotion: its attention scale is a float64 numpy scalar,
which promotes the scores to f32, so from the first block's attention on
the activations are f32 against bf16-rounded weights; the final norm runs
in f32. Products in f32 are true f32 on the card (TF32 off,
``ops.dense.require_true_f32``).

The port cannot draw ``jax.random``'s numbers: ``init_params`` draws from
a ``torch.Generator`` with the reference's distributions and scales, so
one seed gives other untrained weights in the two packages. Weights move
between the packages through checkpoints (``models/checkpoint.py``) or
``convert.encoder_params``. ``param_partition_specs`` is the
reference's tensor-parallel layout over a mesh's model axis (the Megatron
split); :mod:`openintel_tpu_torch.parallel.tensor` shards the trunk by it
and runs the sublayers below, :func:`attention` and :func:`mlp`, on each
shard's heads and MLP columns.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from openintel_tpu_torch.models.checkpoint import flatten
from openintel_tpu_torch.ops.dense import require_true_f32
from openintel_tpu_torch.ops.tokenizer import tokenize

ENCODE_CHUNK = 2048  # texts per encode call of NeuralEmbedder


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32_768
    dim: int = 256
    depth: int = 4
    heads: int = 4
    mlp_ratio: int = 4
    max_len: int = 128
    dtype: str = "float32"  # compute dtype; params stay f32

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


class LayerNorm(nn.Module):
    """The reference's ``_ln`` parameters: gain ``g`` and bias ``b``."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim, device=device))
        self.b = nn.Parameter(torch.zeros(dim, device=device))


class Block(nn.Module):
    """One pre-LN block: ``ln1``, ``qkv``, ``proj``, ``ln2``, ``fc1``,
    ``fc2`` (the reference's names and layout)."""

    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        d, mlp = cfg.dim, cfg.dim * cfg.mlp_ratio
        self.ln1 = LayerNorm(d, device)
        self.qkv = nn.Parameter(torch.zeros(d, 3 * d, device=device))
        self.proj = nn.Parameter(torch.zeros(d, d, device=device))
        self.ln2 = LayerNorm(d, device)
        self.fc1 = nn.Parameter(torch.zeros(d, mlp, device=device))
        self.fc2 = nn.Parameter(torch.zeros(mlp, d, device=device))


class Encoder(nn.Module):
    """The trunk's parameters (``tok_emb``, ``pos_emb``, ``blocks``,
    ``ln_f``); ``forward(ids, mask)`` is :func:`encode`. Made with zero
    weights: :func:`init_params` draws them, a checkpoint loads them."""

    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.dim, device=device))
        self.pos_emb = nn.Parameter(torch.zeros(cfg.max_len, cfg.dim, device=device))
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.depth))
        self.ln_f = LayerNorm(cfg.dim, device)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return encode(self, ids, mask)


def init_params(generator: torch.Generator, cfg: EncoderConfig, device=None) -> Encoder:
    """A new ``Encoder`` with the reference's initialisation (normal draws
    scaled by dim**-0.5, ``fc2`` by mlp**-0.5, unit gains, zero biases),
    drawn on the host from ``generator`` in the reference's order and moved
    to ``device``. Other numbers than ``jax.random``'s for the same seed."""
    scale = cfg.dim**-0.5
    mlp = cfg.dim * cfg.mlp_ratio

    def normal(*shape, std=scale):
        return torch.randn(shape, generator=generator) * std

    model = Encoder(cfg)
    with torch.no_grad():
        model.tok_emb.copy_(normal(cfg.vocab_size, cfg.dim))
        model.pos_emb.copy_(normal(cfg.max_len, cfg.dim))
        for blk in model.blocks:
            blk.qkv.copy_(normal(cfg.dim, 3 * cfg.dim))
            blk.proj.copy_(normal(cfg.dim, cfg.dim))
            blk.fc1.copy_(normal(cfg.dim, mlp))
            blk.fc2.copy_(normal(mlp, cfg.dim, std=mlp**-0.5))
    return model.to(device) if device is not None else model


def nest(named, depth: int) -> dict:
    """(dotted parameter name, value) pairs as a tree in the reference's
    params layout (``tok_emb``, ``pos_emb``, ``blocks`` a list of
    ``depth`` dicts, ``ln_f``)."""
    tree: dict = {}
    for name, value in named:
        *path, last = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = value
    blocks = tree.pop("blocks", {})
    tree["blocks"] = [blocks[str(i)] for i in range(depth)]
    return tree


def param_tree(model: Encoder, leaf=lambda p: p) -> dict:
    """``model``'s parameters in the reference's params layout (``tok_emb``,
    ``pos_emb``, ``blocks`` a list of dicts, ``ln_f``), each leaf
    ``leaf(parameter)``: the tree the checkpoint flattens."""
    return nest(((name, leaf(p)) for name, p in model.named_parameters()), len(model.blocks))


def load_param_tree(model: Encoder, tree) -> Encoder:
    """Copy a tree in the reference's params layout (tensors or numpy
    arrays, as the JAX package's params or a loaded checkpoint hold them)
    into ``model``'s parameters; every parameter must be given once."""
    named = dict(model.named_parameters())
    items = {k.replace("/", "."): v for k, v in flatten(tree).items()}
    if set(items) != set(named):
        raise ValueError(f"params tree mismatch: {sorted(set(items) ^ set(named))[:4]}")
    with torch.no_grad():
        for name, value in items.items():
            if tuple(value.shape) != tuple(named[name].shape):
                raise ValueError(f"{name}: shape {value.shape} != {tuple(named[name].shape)}")
            named[name].copy_(torch.from_numpy(np.array(value, np.float32)))
    return model


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted type of the two, as jnp's ``@`` does."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    m = x.mean(dim=-1, keepdim=True)
    v = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - m) * torch.rsqrt(v + 1e-6) * g.to(dtype) + b.to(dtype)


def attention(y, mask, qkv, proj, heads: int, head_dim: int, dtype) -> torch.Tensor:
    """The attention sublayer's ``o @ proj`` over ``heads`` heads: ``qkv``'s
    columns are q, k and v in turn, each ``heads * head_dim`` wide and
    ordered by head, and ``proj``'s rows follow o's columns."""
    b, s, _ = y.shape
    qkv = _mm(y, qkv.to(dtype)).reshape(b, s, 3, heads, head_dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (b, s, h, hd)
    # the reference divides by a float64 numpy scalar: the scores are f32
    att = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(head_dim)
    att = torch.where(mask[:, None, None, :], att, -1e9)
    att = torch.softmax(att, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", att, v.to(att.dtype)).reshape(b, s, heads * head_dim)
    return _mm(o, proj.to(dtype))


def mlp(y, fc1, fc2, dtype) -> torch.Tensor:
    """The MLP sublayer: ``gelu(y @ fc1) @ fc2`` (tanh GELU)."""
    return _mm(F.gelu(_mm(y, fc1.to(dtype)), approximate="tanh"), fc2.to(dtype))


def _block(x: torch.Tensor, mask: torch.Tensor, p: Block, cfg: EncoderConfig, dtype) -> torch.Tensor:
    y = _ln(x, p.ln1.g, p.ln1.b, dtype)
    x = x + attention(y, mask, p.qkv, p.proj, cfg.heads, cfg.head_dim, dtype)
    return x + mlp(_ln(x, p.ln2.g, p.ln2.b, dtype), p.fc1, p.fc2, dtype)


def embed(tok_emb: torch.Tensor, pos_emb: torch.Tensor, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Token and position embeddings of (B, S) ids, in the compute dtype."""
    return (tok_emb[ids.long()] + pos_emb[: ids.shape[1]][None]).to(dtype)


def pool(x: torch.Tensor, mask: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The final layer norm (f32), mean pooling over the mask and the L2
    norm: (B, S, dim) -> (B, dim)."""
    x = _ln(x.float(), g, b, torch.float32)
    maskf = mask.to(x.dtype)
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1).to(x.dtype)
    pooled = (x * maskf[:, :, None]).sum(dim=1) / denom
    return pooled / torch.clamp(torch.linalg.norm(pooled, dim=1, keepdim=True), min=1e-6)


def encode(model: Encoder, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, S) integer ids + bool mask -> (B, dim) unit-norm f32 embeddings."""
    cfg = model.cfg
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if ids.is_cuda:
        require_true_f32()
    x = embed(model.tok_emb, model.pos_emb, ids, dtype)
    for p in model.blocks:
        x = _block(x, mask, p, cfg, dtype)
    return pool(x, mask, model.ln_f.g, model.ln_f.b)


def param_partition_specs(cfg: EncoderConfig, model_axis: str = "corpus") -> dict:
    """The reference's ``PartitionSpec`` tree for tensor-parallel params
    over ``model_axis``: ``qkv`` and ``fc1`` split their columns, ``proj``
    and ``fc2`` their rows (the Megatron layout: one sum over the axis per
    sublayer), embeddings and layer norms replicated. The shards'
    contents are :mod:`openintel_tpu_torch.parallel.tensor`'s, which cuts
    ``qkv`` by head."""
    from openintel_tpu_torch.parallel.mesh import PartitionSpec as P

    rep = P()
    block = {
        "ln1": {"g": rep, "b": rep},
        "qkv": P(None, model_axis),
        "proj": P(model_axis, None),
        "ln2": {"g": rep, "b": rep},
        "fc1": P(None, model_axis),
        "fc2": P(model_axis, None),
    }
    return {
        "tok_emb": rep,
        "pos_emb": rep,
        "blocks": [block] * cfg.depth,
        "ln_f": {"g": rep, "b": rep},
    }


# ---------------------------------------------------------------------------
# Training: InfoNCE contrastive retrieval + analyzer-head distillation
# ---------------------------------------------------------------------------


def info_nce_loss(model: Encoder, q_ids, q_mask, d_ids, d_mask, temp: float = 0.05) -> torch.Tensor:
    """Symmetric in-batch-negatives contrastive loss over (query, doc) pairs."""
    return contrastive_loss(encode(model, q_ids, q_mask), encode(model, d_ids, d_mask), temp)


def contrastive_loss(qe: torch.Tensor, de: torch.Tensor, temp: float = 0.05) -> torch.Tensor:
    """The symmetric InfoNCE loss of (B, dim) query and doc embeddings."""
    logits = qe @ de.T / temp  # (B, B); diagonal = positives
    diag = torch.arange(qe.shape[0], device=qe.device)
    l_qd = torch.mean(-torch.log_softmax(logits, dim=1)[diag, diag])
    l_dq = torch.mean(-torch.log_softmax(logits, dim=0)[diag, diag])
    return 0.5 * (l_qd + l_dq)


def init_analyzer_head(generator: torch.Generator, cfg: EncoderConfig, device=None) -> dict:
    """The analyzer head ``{"w": (dim, 2), "b": (2,)}``, drawn from
    ``generator`` (other numbers than the reference's for one seed)."""
    w = torch.randn((cfg.dim, 2), generator=generator) * cfg.dim**-0.5
    return {"w": w.to(device), "b": torch.zeros(2, device=device)}


def analyzer_logits(model: Encoder, head: dict, ids, mask) -> torch.Tensor:
    """(B, 2): [polarity in (-1,1) via tanh, speculative logit]."""
    e = encode(model, ids, mask)
    out = e @ head["w"] + head["b"]
    return torch.stack([torch.tanh(out[:, 0]), out[:, 1]], dim=1)


def distill_loss(model: Encoder, head: dict, ids, mask, target_pol, target_spec) -> torch.Tensor:
    """Distill the lexicon analyzer: MSE on polarity + BCE on speculative."""
    out = analyzer_logits(model, head, ids, mask)
    mse = torch.mean((out[:, 0] - target_pol) ** 2)
    logit = out[:, 1]
    bce = torch.mean(
        torch.clamp(logit, min=0) - logit * target_spec + torch.log1p(torch.exp(-torch.abs(logit)))
    )
    return mse + bce


def sgd_train_step(model: Encoder, batch, lr: float = 1e-2) -> torch.Tensor:
    """One InfoNCE step of plain SGD. Unlike the reference's pure function,
    it updates ``model``'s weights in place; returns the loss (before the
    step)."""
    model.zero_grad(set_to_none=True)
    loss = info_nce_loss(model, *batch)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= lr * p.grad
    return loss.detach()


# ---------------------------------------------------------------------------
# Host-facing embedder (the DenseRetriever/HybridRetriever plug-in)
# ---------------------------------------------------------------------------


class NeuralEmbedder:
    """texts -> (N, dim) unit-norm f32 embeddings (a numpy array); a
    drop-in for ``HashingEmbedder``. The trunk lives on ``device`` (the
    card unless the caller asks for the CPU); texts are encoded in chunks
    of 2,048 padded to power-of-two widths. The class name is part of the
    build pipeline's resume key (``index/pipeline.py``), shared with the
    reference, so a resume directory moves between the packages."""

    def __init__(
        self,
        cfg: Optional[EncoderConfig] = None,
        params: Optional[Encoder] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.cfg = cfg or (params.cfg if params is not None else EncoderConfig())
        self.device = torch.device(device)
        if params is None:
            params = init_params(torch.Generator().manual_seed(seed), self.cfg)
        self.params = params.to(self.device)
        self.dim = self.cfg.dim

    def tokenize(self, texts) -> tuple[np.ndarray, np.ndarray]:
        """Texts -> (N, W) int32 ids and bool mask, as the reference's: the
        shared word tokenizer, each token's crc32 hashed into [2,
        vocab_size-1] (0 pads, 1 is the reranker's reserved separator),
        ``[0]`` for a text without tokens, W the smallest power of two
        from 8 that holds the longest row, capped at ``max_len``, and every
        row cut to ``max_len`` tokens."""
        cfg = self.cfg
        rows = []
        for t in texts:
            toks = tokenize(t)[: cfg.max_len]
            rows.append([(zlib.crc32(w.encode()) % (cfg.vocab_size - 2)) + 2 for w in toks] or [0])
        width = 8
        while width < max((len(r) for r in rows), default=1):
            width *= 2
        width = min(width, cfg.max_len)
        ids = np.zeros((len(rows), width), np.int32)
        mask = np.zeros((len(rows), width), bool)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r[:width]
            mask[i, : len(r)] = True
        return ids, mask

    def _encode(self, texts) -> np.ndarray:
        ids, mask = self.tokenize(texts)
        with torch.inference_mode():
            emb = encode(
                self.params,
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device),
            )
        return emb.cpu().numpy()

    def __call__(self, texts) -> np.ndarray:
        # bounded chunks: one call over a whole corpus would hold (N, S, D)
        # activations and (N, H, S, S) scores at once
        texts = list(texts)
        out = np.empty((len(texts), self.dim), np.float32)
        for lo in range(0, len(texts), ENCODE_CHUNK):
            out[lo : lo + ENCODE_CHUNK] = self._encode(texts[lo : lo + ENCODE_CHUNK])
        return out
