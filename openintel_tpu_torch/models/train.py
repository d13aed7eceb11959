"""Encoder training: the port of :mod:`openintel_tpu.models.train`.

Contrastive retrieval training from any text corpus: the "query" for a
document is a random subset of its tokens (with ``synonym_map``, each
query token becomes its synonym surface with probability ``flip_p``).
One step is the InfoNCE loss, its gradients and an AdamW update with
optax's ``adamw(lr)`` settings (b1 0.9, b2 0.999, eps 1e-8, weight decay
1e-4, applied to the weights before the step); checkpoints through
``models/checkpoint.py`` every ``ckpt_every`` steps, resumable mid-run.

The checkpoint holds ``{"params": ..., "opt": (ScaleByAdamState(count,
mu, nu),)}`` under optax's keys (``opt/0/.count``, ``opt/0/.mu/...``,
``opt/0/.nu/...``), which are torch AdamW's ``step``, ``exp_avg`` and
``exp_avg_sq``: a run resumes in either package. Batches are drawn from
``default_rng(seed + start_step)``, as in the reference, so both packages
draw the same batches.

With ``mesh`` (a ``parallel.mesh.Mesh``), the run is data parallel over
the "data" axis and tensor parallel (the Megatron split,
:mod:`openintel_tpu_torch.parallel.tensor`) over "corpus", as the
reference's: the full weights are drawn (or loaded) first and then cut
into per-shard masters, the InfoNCE loss is over the global batch, and
AdamW's moments are sharded like their params (the update is
elementwise, so each shard's step is the full step's). The checkpoint is
gathered into the reference's layout, so it resumes on any mesh or none,
in either package.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from openintel_tpu_torch.index.synthetic import flip_tokens
from openintel_tpu_torch.models.checkpoint import flatten, load_meta, load_params, save_params
from openintel_tpu_torch.models.encoder import (
    Encoder,
    EncoderConfig,
    NeuralEmbedder,
    info_nce_loss,
    init_params,
    load_param_tree,
    param_tree,
)
from openintel_tpu_torch.parallel import tensor as tp

# optax.adamw's defaults
BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


class ScaleByAdamState(NamedTuple):
    """optax's Adam state, whose field names are the checkpoint's keys."""

    count: Any
    mu: Any
    nu: Any


@dataclass
class TrainResult:
    params: Encoder
    losses: list[float]
    step: int


def make_pairs(
    texts: Sequence[str],
    embedder: NeuralEmbedder,
    batch_size: int,
    rng: np.random.Generator,
    synonym_map: Optional[dict] = None,
    flip_p: float = 0.5,
    device=None,
):
    """Sample a (query, doc) batch, the reference's draws from ``rng``:
    queries are random token subsets of their docs (synonym-flipped with
    ``synonym_map``). Returns (q_ids, q_mask, d_ids, d_mask) tensors on
    ``device`` (the host by default), both sides padded to one width."""
    idx = rng.integers(0, len(texts), size=batch_size)
    docs = [texts[i] for i in idx]
    queries = []
    for d in docs:
        toks = d.split()
        take = max(1, min(len(toks), int(rng.integers(1, 5))))
        chosen = list(rng.choice(toks, size=take, replace=False))
        if synonym_map:
            chosen = flip_tokens(chosen, synonym_map, flip_p, rng)
        queries.append(" ".join(chosen))
    q_ids, q_mask = embedder.tokenize(queries)
    d_ids, d_mask = embedder.tokenize(docs)
    width = max(q_ids.shape[1], d_ids.shape[1])

    def pad(a, fill):
        out = np.full((a.shape[0], width), fill, a.dtype)
        out[:, : a.shape[1]] = a
        return torch.from_numpy(out).to(device)

    return pad(q_ids, 0), pad(q_mask, False), pad(d_ids, 0), pad(d_mask, False)


def _tree(model, leaf) -> dict:
    """``model``'s parameters (an ``Encoder`` or a ``ShardedEncoder``,
    gathered) in the reference's params layout, each leaf ``leaf(p)``."""
    return model.tree(leaf) if isinstance(model, tp.ShardedEncoder) else param_tree(model, leaf)


def state_tree(model, opt: Optional[torch.optim.Optimizer] = None) -> dict:
    """The checkpoint's tree: ``model``'s params and the optimizer's state
    under optax's names, a sharded model's gathered into the reference's
    arrays. Without ``opt``, a template of the right shapes (count 0, the
    moments the params themselves)."""
    params = _tree(model, lambda p: p.detach())
    if opt is None:
        count, mu, nu = np.zeros((), np.int32), params, params
    else:
        count = np.int32(int(opt.state[next(iter(model.parameters()))]["step"]))
        mu = _tree(model, lambda p: opt.state[p]["exp_avg"])
        nu = _tree(model, lambda p: opt.state[p]["exp_avg_sq"])
    return {"params": params, "opt": (ScaleByAdamState(count, mu, nu),)}


def _restore(model, opt: torch.optim.Optimizer, loaded: dict) -> None:
    """A loaded checkpoint into ``model`` and AdamW's state (optax's count
    is AdamW's ``step``, mu its ``exp_avg``, nu its ``exp_avg_sq``); on a
    ``ShardedEncoder`` each array is cut into its masters' shards."""
    adam = loaded["opt"][0]
    if isinstance(model, tp.ShardedEncoder):
        params, mu, nu = (
            tp.flat_leaves(tp.shard_tree(t, model.parts)) for t in (loaded["params"], adam.mu, adam.nu)
        )
        slots = [(p, params[k][m], mu[k][m], nu[k][m]) for k, m, p in model.named_masters()]
    else:
        named = dict(model.named_parameters())
        params, mu, nu = (flatten(t) for t in (loaded["params"], adam.mu, adam.nu))
        slots = [
            (named[k.replace("/", ".")], *(torch.from_numpy(t[k]) for t in (params, mu, nu)))
            for k in params
        ]
    with torch.no_grad():
        for p, value, m1, m2 in slots:
            p.copy_(value)
            opt.state[p] = {
                "step": torch.tensor(float(adam.count), dtype=torch.float32),
                "exp_avg": m1.to(p.device),
                "exp_avg_sq": m2.to(p.device),
            }


def _adamw(model, lr: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(
        model.parameters(), lr=lr, betas=BETAS, eps=EPS, weight_decay=WEIGHT_DECAY
    )


def _check_mesh(mesh, cfg: EncoderConfig, batch_size: int, device: torch.device) -> None:
    """The reference's refusals (its texts), then the port's: a mesh over
    several processes, a ``device`` of another type than the mesh's."""
    tp.check_mesh(cfg, mesh)
    data = mesh.shape["data"]
    if batch_size % data:
        raise ValueError(f"batch size {batch_size} must divide by the data axis ({data})")
    if mesh.home.type != device.type:
        raise ValueError(
            f"device {device.type!r} is not the mesh's ({mesh.home.type!r}): a mesh trains on "
            "its own cells"
        )


def train_encoder(
    texts: Sequence[str],
    cfg: Optional[EncoderConfig] = None,
    *,
    steps: int = 50,
    batch_size: int = 16,
    lr: float = 1e-3,
    seed: int = 0,
    ckpt_dir: Optional[str | Path] = None,
    ckpt_every: int = 25,
    log: Optional[Callable[[str], None]] = None,
    mesh=None,
    synonym_map: Optional[dict] = None,
    flip_p: float = 0.5,
    device="cuda",
) -> TrainResult:
    """Train (or resume) the encoder on ``device`` (the card unless the
    caller asks for the CPU), or over ``mesh``'s cells (``device`` then
    names their type); returns the trained ``Encoder`` (gathered on the
    mesh's home device) and the loss of each step run. A checkpoint at or
    past ``steps`` is left as it is, meta included, and nothing runs."""
    cfg = cfg or EncoderConfig()
    device = torch.device(device)
    if mesh is not None:
        _check_mesh(mesh, cfg, batch_size, device)
    # the full weights first, then (on a mesh) their shards: one seed
    # starts a mesh run and a one-device run from the same weights
    model = init_params(torch.Generator().manual_seed(seed), cfg, device if mesh is None else None)
    if mesh is not None:
        model = tp.shard_encoder(model, mesh)
    opt = _adamw(model, lr)

    start_step = 0
    ckpt_path = Path(ckpt_dir) / "encoder" if ckpt_dir is not None else None
    if ckpt_path is not None and ckpt_path.with_suffix(".npz").exists():
        # resume BOTH params and optimizer moments: restarting AdamW's
        # state on trained params takes oversized early steps
        _restore(model, opt, load_params(state_tree(model), ckpt_path))
        start_step = int(load_meta(ckpt_path).get("step", 0))
        if log:
            log(f"resumed from step {start_step}")

    def result(losses, step):
        params = tp.gather_encoder(model) if mesh is not None else model
        return TrainResult(params=params, losses=losses, step=step)

    # checkpoint already at/past the request: no-op, and the meta is NOT
    # rewritten with a smaller step (a later longer run would otherwise
    # retrain on already-trained params)
    if start_step >= steps:
        return result([], start_step)

    if mesh is None:
        embedder, loss_fn, batch_device = NeuralEmbedder(cfg, model, device=device), info_nce_loss, device
    else:  # the embedder only tokenizes here, so its weights may be zeros
        embedder = NeuralEmbedder(cfg, Encoder(cfg), device="cpu")
        loss_fn, batch_device = tp.info_nce_loss, mesh.home
    rng = np.random.default_rng(seed + start_step)
    losses: list[float] = []
    for step in range(start_step, steps):
        batch = make_pairs(
            texts, embedder, batch_size, rng,
            synonym_map=synonym_map, flip_p=flip_p, device=batch_device,
        )
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, *batch)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if log and (step % 10 == 0 or step == steps - 1):
            log(f"step {step}: loss {losses[-1]:.4f}")
        if ckpt_path is not None and (step + 1) % ckpt_every == 0:
            save_params(state_tree(model, opt), ckpt_path, config=cfg, step=step + 1)
    if ckpt_path is not None:
        save_params(state_tree(model, opt), ckpt_path, config=cfg, step=steps)
    return result(losses, steps)


def load_embedder(ckpt_dir: str | Path, device="cuda") -> NeuralEmbedder:
    """Reload a trained encoder (a checkpoint of either package) as a
    retriever-pluggable embedder on ``device``."""
    ckpt_path = Path(ckpt_dir) / "encoder"
    meta = load_meta(ckpt_path)
    cfg = EncoderConfig(**meta["config"]) if "config" in meta else EncoderConfig()
    model = Encoder(cfg)
    # checkpoints hold {params, opt}; the whole key set is checked
    load_param_tree(model, load_params(state_tree(model), ckpt_path)["params"])
    return NeuralEmbedder(cfg, model, device=device)
