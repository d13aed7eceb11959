"""The port's corpus index: postings (CSR), dense embeddings, BM25 stats,
synthetic corpora. Copies of the reference package's jax-free index
modules, held equal to them in tests/test_torch_host_copies.py."""
