"""The benchmark of ``warmup_fir_filter_tpu_torch`` on NVIDIA H100 cards.

Run one cell once with ``python3 -m portbench.run --workload NAME --seed N
--seconds S --trace 0|1`` from the root of a checkout; ``BENCHMARK.json``
names the cells.  Nothing here imports JAX, the JAX package
(``warmup_fir_filter_tpu``), the port's benches, ``chip_smoke`` or
``probe_kernels``; the reference (``portbench/reference.py``) imports
nothing of the port.
"""
