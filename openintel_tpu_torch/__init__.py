"""openintel-tpu on PyTorch: the hybrid search path for NVIDIA Hopper.

A port of :mod:`openintel_tpu` (JAX/Pallas, the reference it is held
against) to PyTorch, with the Pallas kernels of the main path rewritten as
CUDA C++ for ``sm_90a`` (``openintel_tpu_torch/csrc``). The port imports
``torch`` and never ``jax``; it reuses only the jax-free modules of the
reference package (``openintel_tpu.index``, ``openintel_tpu.native``,
``openintel_tpu.ops.tokenizer``, ``openintel_tpu.ops.reference``).

Importing this package initialises neither CUDA nor jax: the retrievers
and kernels load on first use.
"""

__version__ = "0.1.0"


def default_device():
    """The device a retriever runs on when none is given: cuda when a card
    is present, else cpu (the counterpart of ``jax.default_backend()``)."""
    import torch

    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


_DENSE_OPS = (
    "dense_topk_fast",  # kernel D
    "dense_topk_fast_i4",  # kernels E1/E2
    "dense_topk_fast_i8_grouped",  # kernel A
    "dense_topk_pallas",  # kernel B
    "exact_rescore",
    "pack_corpus_i4",
    "pad_corpus_rows",
    "quantize_int4",
    "quantize_int8",
)


def __getattr__(name):  # lazy exports (nothing heavy at import time)
    if name in ("BM25Retriever", "DenseRetriever", "HybridRetriever"):
        from openintel_tpu_torch.models import retrievers

        return getattr(retrievers, name)
    if name in _DENSE_OPS:
        from openintel_tpu_torch.ops import dense_topk

        return getattr(dense_topk, name)
    raise AttributeError(
        f"module 'openintel_tpu_torch' has no attribute {name!r}"
    )
