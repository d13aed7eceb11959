"""Retriever families of the port: BM25, dense cosine and the hybrid."""
