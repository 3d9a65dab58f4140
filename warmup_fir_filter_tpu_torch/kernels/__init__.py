"""Hand-written CUDA kernels for Hopper, their wrappers and dispatch.

- ``fir_band``    kernel A (``csrc/fir_band.cu``), ports the TPU band
                  kernels K1/K2 (``fir_mxu.py``), L ≤ 257;
- ``fir_direct``  kernel B (``csrc/fir_direct.cu``), ports the TPU
                  direct-form kernel K4 (``fir_pallas.py``), any L;
- ``dispatch``    ``fir1d_fixed_rows_auto``.
"""
