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


def __getattr__(name):  # lazy exports (nothing heavy at import time)
    if name in ("BM25Retriever", "DenseRetriever", "HybridRetriever"):
        from openintel_tpu_torch.models import retrievers

        return getattr(retrievers, name)
    raise AttributeError(
        f"module 'openintel_tpu_torch' has no attribute {name!r}"
    )
