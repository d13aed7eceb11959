"""openintel-tpu on PyTorch: the hybrid search path for NVIDIA Hopper.

A port of the ``openintel_tpu`` package (JAX/Pallas, the reference it is
held against) to PyTorch, with every Pallas kernel rewritten as CUDA C++
for ``sm_90a`` (``openintel_tpu_torch/csrc``). The port imports ``torch``
and never ``jax``, and nothing of the reference package: it keeps its own
copies of the host modules it needs (``index``, ``native``,
``ops.tokenizer``), held equal to the originals in the tests.

Importing this package initialises no CUDA: the retrievers and kernels
load on first use. Its entry points run on the card unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"


def default_device():
    """The device a retriever runs on when none is given: always cuda.
    Without a card the first device tensor fails with CUDA's own error;
    nothing moves to the CPU unless the caller asks with ``device="cpu"``."""
    import torch

    return torch.device("cuda")


_DENSE_OPS = (
    "dense_topk_fast",  # kernel D
    "dense_topk_fast_i4",  # kernels E1/E2
    "dense_topk_fast_i8",  # kernels C1/C2
    "dense_topk_fast_i8_grouped",  # kernel A
    "dense_topk_pallas",  # kernel B
    "dot_only",  # kernel S
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
