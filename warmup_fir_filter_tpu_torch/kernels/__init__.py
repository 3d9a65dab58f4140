"""Hand-written CUDA kernels for Hopper, their wrappers and dispatch.

- ``fir_band``     kernel A (``csrc/fir_band.cu``), ports the TPU band
                   kernels K1/K2 (``fir_mxu.py``), L ≤ 257;
- ``fir_direct``   kernel B (``csrc/fir_direct.cu``), ports the TPU
                   direct-form kernel K4 (``fir_pallas.py``), any L;
- ``fir_window``   kernel C (``csrc/fir_window.cu``), ports the TPU
                   windowed band kernel K3 (``fir_mxu.py``), L ≤ 4,096;
- ``window_copy``  kernel D (``csrc/window_copy.cu``), ports the TPU
                   window-copy kernel K5 (``window_copy.py``);
- ``fir2d``        kernels E, F and G (``csrc/fir2d_frame.cu``,
                   ``csrc/fir2d_bf16.cu``), port the TPU 2-D frame kernels
                   K6/K7 and the bf16 kernel K8 (``fir2d_mxu.py``);
- ``fir_float``    kernel H (``csrc/fir_float.cu``), ports the TPU float
                   FIR kernels K9 (``fir_float_mxu.py``), L ≤ 257;
- ``resample``     kernel I (``csrc/resample.cu``), ports the TPU polyphase
                   resampler K10 (``resample_mxu.py``);
- ``chain_fused``  kernel J (``csrc/chain_fused.cu``), ports the TPU fused
                   chain K11 (``chain_fused.py``);
- ``fft``          kernels K, L and M (``csrc/fft_rows.cu``,
                   ``csrc/osfilt.cu``, ``csrc/osfilt_stream.cu``), port the
                   TPU row FFT K12, the framed overlap-save filter K13 and
                   the stream overlap-save filter K14 (``fft_pallas.py``);
- ``copy_rows``    kernel N (``csrc/copy_rows.cu``), ports the roofline
                   harness's in-place copy K15 (``bench_roofline.py``);
- ``dispatch``     ``prepare_fixed_fir``, ``fir1d_fixed_rows_auto`` and
                   ``fir2d_fixed_auto``.

The package exports the JAX package's 14 kernel entries under their names;
each runs on its input tensor's device, and each that filters or pads
puts a host array on the card, as the JAX functions put it on their
accelerator (``crop_frame_overlap`` slices the frame it is given).
``fir1d_fixed_rows_mxu_window``,
``resample_poly_mxu`` and ``window_rows_pallas`` live in their modules, as
in the JAX package.
"""

from warmup_fir_filter_tpu_torch.kernels.fir_direct import (
    fir1d_fixed_rows_pallas,
)
from warmup_fir_filter_tpu_torch.kernels.fir_band import fir1d_fixed_rows_mxu
from warmup_fir_filter_tpu_torch.kernels.fir_float import fir1d_ideal_rows_mxu
from warmup_fir_filter_tpu_torch.kernels.fir2d import (
    crop_frame_overlap,
    fir2d_fixed_frame,
    fir2d_fixed_frame_overlap,
    fir2d_fixed_mxu,
    pad_frame,
    pad_frame_overlap,
)
from warmup_fir_filter_tpu_torch.kernels.fft import (
    fft_rows_pallas,
    fir_overlap_save_pallas,
    fir_overlap_save_quantized_pallas,
)
from warmup_fir_filter_tpu_torch.kernels.dispatch import (
    fir1d_fixed_rows_auto,
    fir2d_fixed_auto,
)

__all__ = [
    "fir1d_fixed_rows_pallas",
    "fir1d_fixed_rows_mxu",
    "fir1d_ideal_rows_mxu",
    "fir2d_fixed_mxu",
    "fir2d_fixed_frame",
    "fir2d_fixed_frame_overlap",
    "crop_frame_overlap",
    "pad_frame",
    "pad_frame_overlap",
    "fft_rows_pallas",
    "fir_overlap_save_pallas",
    "fir_overlap_save_quantized_pallas",
    "fir1d_fixed_rows_auto",
    "fir2d_fixed_auto",
]
