"""Device ops of the port: BM25 reduction, dense top-k, rank fusion.

Each op mirrors the function of the same name in :mod:`openintel_tpu.ops`
and is held equal to it in ``tests/test_torch_*.py``.
"""
