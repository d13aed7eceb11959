"""Deterministic hashed random-projection text embedder.

The port's copy of the reference's ``models.embedding``, held equal to it
in tests/test_torch_retriever.py.

Gives the framework a self-contained dense arm with zero external model
dependencies: each token hashes to a seed that generates a pseudo-random
Gaussian vector; a document embedding is the L2-normalised sum of its token
vectors. Deterministic across processes/platforms (blake2b + PCG64 per token),
so indexes and queries embed identically everywhere. Swap in a real encoder by
passing any (texts -> (N, D) array) callable where an embedder is accepted.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

from openintel_tpu_torch.ops.tokenizer import tokenize_batch

DEFAULT_DIM = 384


class HashingEmbedder:
    def __init__(self, dim: int = DEFAULT_DIM, seed: int = 0):
        self.dim = dim
        self.seed = seed
        self._cache: dict[str, np.ndarray] = {}

    def _token_vector(self, token: str) -> np.ndarray:
        vec = self._cache.get(token)
        if vec is None:
            digest = hashlib.blake2b(
                f"{self.seed}:{token}".encode(), digest_size=8
            ).digest()
            rng = np.random.Generator(
                np.random.PCG64(int.from_bytes(digest, "little"))
            )
            vec = rng.standard_normal(self.dim).astype(np.float32)
            self._cache[token] = vec
        return vec

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, tokens in enumerate(tokenize_batch(texts)):
            for t in tokens:
                out[i] += self._token_vector(t)
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-12)
