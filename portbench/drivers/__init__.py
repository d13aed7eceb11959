"""One driver for each kind of traffic, found by a mix's ``entry``: the
file ``drivers/<entry>.py``. Each holds ``HYBRID`` (whether the inputs
need postings), ``plan(cfg, traffic, inputs)``,
the shape of the answers the reference stages (``check.Plan``), and
``build(cfg, traffic, inputs, seed, device)``, the driver: ``retriever``,
``warm()``, ``run(seconds, tracer)`` and ``close()``. A new kind of
traffic is a new file here."""
