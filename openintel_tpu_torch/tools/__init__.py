"""Measurement tools of the int8 candidate pass, the port's counterparts of
the reference's ``scripts/bench_kernel_decomp.py``,
``scripts/bench_topk_reduce_ab.py`` and ``scripts/bench_grouped_ab.py``.

Run each as ``python -m openintel_tpu_torch.tools.<name> [N_DOCS] [BATCH]
[NB] [--device cpu]``; each module's core takes an already built corpus and
queries, so ``chip_smoke.py`` and the tests call it directly.
``stream_ablation`` (card only) splits the time of kernels A and D on
their TMA + wgmma stream between the stream, the products and the fold.
"""
