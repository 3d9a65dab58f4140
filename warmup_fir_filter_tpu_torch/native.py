"""ctypes bindings to the native C++ tools library (``tools/``).

The port's own binding to the host tools of ``tools/src``, with the public
surface of ``warmup_fir_filter_tpu/native.py``: a streaming Direct-Form-I
FIR, a bit-exact fixed-point golden oracle, a radix-2 FFT over the
complex/twiddle library, and a golden-vector bit-compare.  Numpy in, numpy
out; a torch tensor is accepted too, and a CUDA one is copied to the host
(``.cpu()``) first, so a kernel's output can be handed to the oracle.

The tools run on the host.  :func:`load_native` builds the library at its
first call with the host C++ compiler (``_build.build_tools``: one ``c++
-O2 -std=c++17 -fPIC -shared`` over the sources ``tools/CMakeLists.txt``
names) into ``build/warmup_fir_filter_tpu_torch/libwft_tools.so``, stamped
with the SHA-256 of its flags and sources, and rebuilds when they change.
Without a compiler it raises ``_build.BuildError`` naming the missing
compiler; :func:`native_available` says beforehand whether a load can
succeed.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

_lib: ctypes.CDLL | None = None


def _host(x) -> np.ndarray:
    """``x`` as a numpy array; a tensor is detached and copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def native_available() -> bool:
    """True when the stamped library is built or a C++ compiler can build it."""
    if _lib is not None or _build.tools_built():
        return True
    try:
        _build.find_cxx()
    except _build.BuildError:
        return False
    return True


def load_native() -> ctypes.CDLL:
    """The tools' library with its C signatures set; built at first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build.build_tools()))

    i64 = ctypes.c_int64
    lib.wft_fir1d_fixed_rows.restype = ctypes.c_int
    lib.wft_fir1d_fixed_rows.argtypes = [
        ctypes.c_void_p, i64, i64, ctypes.c_void_p, i64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.wft_stream_create.restype = ctypes.c_void_p
    lib.wft_stream_create.argtypes = [ctypes.c_void_p, i64]
    lib.wft_stream_destroy.restype = None
    lib.wft_stream_destroy.argtypes = [ctypes.c_void_p]
    lib.wft_stream_reset.restype = None
    lib.wft_stream_reset.argtypes = [ctypes.c_void_p]
    lib.wft_stream_process.restype = None
    lib.wft_stream_process.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_void_p
    ]
    lib.wft_bit_compare_u8.restype = None
    lib.wft_bit_compare_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.wft_fft_radix2.restype = ctypes.c_int
    lib.wft_fft_radix2.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_int
    ]
    _lib = lib
    return lib


def fir1d_fixed_rows_native(
    x_u8, h, qformat: QFormat = QFormat()
) -> np.ndarray:
    """Bit-exact fixed FIR via the native oracle (same golden contract)."""
    lib = load_native()
    x = np.ascontiguousarray(_host(x_u8), dtype=np.uint8)
    if x.ndim != 2:
        raise ValueError(f"expected (B, N) rows, got shape {x.shape}")
    taps = np.ascontiguousarray(
        qformat.quantize_coeffs(_host(h)).astype(np.int64)
    )
    out = np.empty_like(x)
    rc = lib.wft_fir1d_fixed_rows(
        x.ctypes.data, x.shape[0], x.shape[1],
        taps.ctypes.data, taps.size,
        qformat.coeff_bits, qformat.frac_bits, qformat.acc_bits,
        out.ctypes.data,
    )
    if rc != 0:
        raise ValueError("wft_fir1d_fixed_rows rejected its arguments")
    return out


class NativeFirStream:
    """Sample-streaming float FIR backed by the C++ delay-line model."""

    def __init__(self, taps):
        self._handle = None
        self._lib = load_native()
        taps64 = np.ascontiguousarray(_host(taps), dtype=np.float64)
        self._handle = self._lib.wft_stream_create(
            taps64.ctypes.data, taps64.size
        )
        if not self._handle:
            raise ValueError("invalid taps for native stream")

    def process(self, x) -> np.ndarray:
        if not self._handle:
            raise ValueError("the stream is closed")
        x64 = np.ascontiguousarray(_host(x), dtype=np.float64)
        out = np.empty_like(x64)
        self._lib.wft_stream_process(
            self._handle, x64.ctypes.data, x64.size, out.ctypes.data
        )
        return out

    def reset(self) -> None:
        if not self._handle:
            raise ValueError("the stream is closed")
        self._lib.wft_stream_reset(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.wft_stream_destroy(self._handle)
            self._handle = None

    def __del__(self):
        # At interpreter exit the module globals may already be gone; the
        # handle's memory goes with the process then.
        try:
            self.close()
        except Exception:
            pass


def bit_compare_u8(a, b) -> dict:
    """Golden-vector bit-compare via the native tool."""
    lib = load_native()
    a8 = np.ascontiguousarray(_host(a), dtype=np.uint8).reshape(-1)
    b8 = np.ascontiguousarray(_host(b), dtype=np.uint8).reshape(-1)
    if a8.size != b8.size:
        raise ValueError(f"Size mismatch: {a8.size} vs {b8.size}")
    mism = ctypes.c_int64()
    max_err = ctypes.c_int64()
    mae = ctypes.c_double()
    rmse = ctypes.c_double()
    lib.wft_bit_compare_u8(
        a8.ctypes.data, b8.ctypes.data, a8.size,
        ctypes.byref(mism), ctypes.byref(max_err),
        ctypes.byref(mae), ctypes.byref(rmse),
    )
    return {
        "num_samples": int(a8.size),
        "num_mismatches": int(mism.value),
        "max_abs_err": int(max_err.value),
        "mae": float(mae.value),
        "rmse": float(rmse.value),
        "bit_exact": mism.value == 0,
    }


def fft_radix2_native(re, im,
                      inverse: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Radix-2 FFT via the native complex/twiddle library."""
    lib = load_native()
    # The C call transforms in place: work on copies of the inputs.
    re64 = np.array(_host(re), dtype=np.float64, order="C")
    im64 = np.array(_host(im), dtype=np.float64, order="C")
    if re64.size != im64.size:
        raise ValueError(f"Size mismatch: {re64.size} vs {im64.size}")
    rc = lib.wft_fft_radix2(
        re64.ctypes.data, im64.ctypes.data, re64.size, int(inverse)
    )
    if rc != 0:
        raise ValueError("fft size must be a power of two")
    return re64, im64
