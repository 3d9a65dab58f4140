"""The root benches' counterparts, on the card.

Each module is the port of the JAX bench of the same name at the repo root
and runs as ``python -m warmup_fir_filter_tpu_torch.benches.<name>``
(``--device cpu`` runs the plain versions, for the tests):

- ``bench_roofline``  the bandwidth wall: kernel N (``copy_rows_``),
                      ``copy_``, elementwise passes and kernel A;
- ``bench``           the headline: the 5-tap fixed FIR through kernel A,
                      its ``wall_msps`` from kernel N in the same run;
- ``bench_taps``      the fixed FIR at 5-4,096 taps (kernels A and C);
- ``bench_streaming`` the checkpointed 16 × 4,000,000 stream (D and A);
- ``bench_2d``        the 8192² 2-D FIR on kernels F, E and G;
- ``bench_configs``   the five BASELINE configurations;
- ``bench_scaling``   halo overhead, weak scaling and pipeline overlap over
                      gloo or NCCL worlds, one process a rank.

``_common`` holds the card line, the JSON line and the timing.
"""
