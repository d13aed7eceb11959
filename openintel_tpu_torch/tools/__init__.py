"""Measurement tools, the port's counterparts of the reference's scripts.

The int8 candidate pass: ``kernel_decomp``, ``topk_reduce_ab`` and
``grouped_ab`` (``scripts/bench_kernel_decomp.py``,
``bench_topk_reduce_ab.py``, ``bench_grouped_ab.py``), each run as ``python
-m openintel_tpu_torch.tools.<name> [N_DOCS] [BATCH] [NB] [--device cpu]``.
The host and serving side: ``profile_planner`` (the C++ planner's phases),
``coalescer`` and ``arrival`` (closed- and open-loop serving through the
``BatchCoalescer``), ``sharded_overhead`` (an 8-cell mesh on one device);
quality: ``encoder_quality`` and ``fusion_ab``; the dense arm's widths:
``batch_ab`` (kernel C2 at sub-batches of 256 to 1,024) and ``int4_ab``
(C2 against E2). These take their scripts' arguments and environment
variables, run on the card unless ``--device cpu``, and write a JSON
stamped with the backend and the card to ``--out`` (default under the
ignored ``build/tools/``). Each module's core takes an already built
corpus or retriever, so ``chip_smoke.py`` and the tests call it directly.
``stream_ablation`` (card only) splits the time of the stream kernels
between the stream, the products and the fold; ``ptxas_report`` and
``serving_ab`` compare builds and trees.
"""
