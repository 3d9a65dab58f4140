"""Build the CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``, all
started together, and the objects are linked into
``build/warmup_fir_filter_tpu_torch/libwft_kernels.so`` beside the package,
at first use: the build lasts as long as its slowest source, not their
sum.  The sources have a plain C interface and include no PyTorch header,
which keeps the build to seconds.  A stamp file beside
the library holds the SHA-256 of the sources and flags; a changed source
rebuilds.  A missing ``nvcc`` or a failed build raises :class:`BuildError`:
nothing falls back to a plain version.

The host C++ tools of ``tools/src`` (the fixed-point oracle, the streaming
FIR, the radix-2 FFT and the bit-compare; bound by ``native.py``) are built
the same way by :func:`build_tools`, with the host compiler, into
``libwft_tools.so`` in the same directory under their own stamp.

Calling convention of every C entry point: device pointers and the CUDA
stream go in as ``ctypes.c_void_p`` (ctypes would cut a pointer passed
as a plain int to 32 bits), and the function returns
``cudaGetLastError()`` after its launch, which :func:`check_launch` turns
into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
DEFAULT_BUILD_DIR = PACKAGE_DIR.parent / "build" / "warmup_fir_filter_tpu_torch"
LIBRARY_NAME = "libwft_kernels.so"
#: Where the CUDA toolkit installs by default; searched after CUDA_HOME
#: and PATH.
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
#: Flags of every nvcc call; the link adds ``-shared``.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
#: The host tools' sources, as ``tools/CMakeLists.txt`` declares them.
TOOLS_SRC_DIR = PACKAGE_DIR.parent / "tools" / "src"
TOOLS_SOURCES = ("wft_complex.cpp", "wft_fir.cpp", "wft_capi.cpp")
TOOLS_LIBRARY_NAME = "libwft_tools.so"
#: Flags of the one host-compiler call that builds the tools' library.
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
#: Host compilers searched on PATH after ``$CXX``.
CXX_NAMES = ("c++", "g++", "clang++")

_VOIDP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
#: Kernels E and F: x, y, hp, wp, digits (device), plane table (device),
#: planes, taps_r, taps_c, t0, core_h, core_w, bias, needs_wrap, frac_bits,
#: acc_bits, stream.
_FIR2D_INT = (
    [_VOIDP, _VOIDP, _LL, _LL, _VOIDP, _VOIDP, _INT, _INT, _INT, _INT, _INT,
     _INT, ctypes.c_uint32, _INT, _INT, _INT, _VOIDP],
    _INT,
)
#: C signature of each entry point: (argtypes, restype).
_SIGNATURES = {
    # x, y, rows, n, digits, planes, taps, exponents (host), bias,
    # needs_wrap, frac_bits, acc_bits, int32 taps (host), stream
    "wft_fir_band": (
        [_VOIDP, _VOIDP, _LL, _LL, _VOIDP, _INT, _INT, _VOIDP,
         ctypes.c_uint32, _INT, _INT, _INT, _VOIDP, _VOIDP],
        _INT,
    ),
    # x, y, rows, n, taps, int32 taps (host), bias, needs_wrap, frac_bits,
    # acc_bits, copy words (device), copy_words, chunk table (device),
    # chunk table (host), chunks, planes, stream
    "wft_fir_direct": (
        [_VOIDP, _VOIDP, _LL, _LL, _INT, _VOIDP, ctypes.c_uint32, _INT, _INT,
         _INT, _VOIDP, _INT, _VOIDP, _VOIDP, _INT, _INT, _VOIDP],
        _INT,
    ),
    # x, y, rows, n, digit words (device), digit_words, planes, taps,
    # plane table (host), bias, needs_wrap, frac_bits, acc_bits, stream
    "wft_fir_window": (
        [_VOIDP, _VOIDP, _LL, _LL, _VOIDP, _INT, _INT, _INT, _VOIDP,
         ctypes.c_uint32, _INT, _INT, _INT, _VOIDP],
        _INT,
    ),
    # x, carry_ext, out, channels, total, sub, stream
    "wft_window_rows": (
        [_VOIDP, _VOIDP, _VOIDP, _LL, _LL, _LL, _VOIDP],
        _INT,
    ),
    "wft_fir2d_frame": _FIR2D_INT,
    "wft_fir2d_oframe": _FIR2D_INT,
    # x, y, hp, wp, row taps (device f32), row table (device), rows, taps_r,
    # taps_c, t0, core_h, core_w, frac_bits, stream
    "wft_fir2d_bf16": (
        [_VOIDP, _VOIDP, _LL, _LL, _VOIDP, _VOIDP, _INT, _INT, _INT, _INT,
         _INT, _INT, _INT, _VOIDP],
        _INT,
    ),
    # x, y, rows, n, taps (device f32), num_taps, x_is_u8, stream
    "wft_fir_float": (
        [_VOIDP, _VOIDP, _LL, _LL, _VOIDP, _INT, _INT, _VOIDP],
        _INT,
    ),
    # x, y, rows, n, out_len, branch taps (device f32), up, down, center,
    # taps per branch, tap row stride, stream
    "wft_resample": (
        [_VOIDP, _VOIDP, _LL, _LL, _LL, _VOIDP, _INT, _INT, _INT, _INT, _INT,
         _VOIDP],
        _INT,
    ),
    # x_re, x_im, y, channels, n, out_len, branch taps, up, down, center,
    # taps per branch, tap row stride, channelizer taps (device f32),
    # channelizer length, lo, hi, inv_gain, bf16, stream
    "wft_chain_fused": (
        [_VOIDP, _VOIDP, _VOIDP, _LL, _LL, _LL, _VOIDP, _INT, _INT, _INT,
         _INT, _INT, _VOIDP, _INT, _LL, _LL, ctypes.c_float, _INT, _VOIDP],
        _INT,
    ),
    # xr, xi (null for a real input), yr, yi, rows, log2 nfft, twiddles
    # (device), inverse, stream
    "wft_fft_rows": (
        [_VOIDP, _VOIDP, _VOIDP, _VOIDP, _LL, _INT, _VOIDP, _INT, _VOIDP],
        _INT,
    ),
    # segments, y, batch, log2 nfft, twiddles, spectrum (device),
    # seg_is_u8, out_u8, stream
    "wft_osfilt": (
        [_VOIDP, _VOIDP, _LL, _INT, _VOIDP, _VOIDP, _INT, _INT, _VOIDP],
        _INT,
    ),
    # x, y, channels, tx, out_len, hop, first window start, twiddles,
    # spectrum (device), x_is_u8, out_u8, stream
    "wft_osfilt_stream": (
        [_VOIDP, _VOIDP, _LL, _LL, _LL, _INT, _INT, _VOIDP, _VOIDP, _INT,
         _INT, _VOIDP],
        _INT,
    ),
    "wft_error_string": ([_INT], ctypes.c_char_p),
}

#: Loaded libraries by build directory, one per process.
_LOADED: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """A compiler (nvcc, or the host's for the tools) is missing or
    refused the sources."""


class LaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def find_nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then PATH, then the default home."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = DEFAULT_CUDA_HOME / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise BuildError(
        "nvcc not found (searched $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin); the CUDA kernels cannot be built."
    )


def kernel_sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_digest() -> str:
    """SHA-256 over the flags and every source and header in ``csrc/``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()


def _up_to_date(library: Path, digest: str) -> bool:
    stamp = library.with_name(f"{library.name}.sha256")
    return (library.is_file() and stamp.is_file()
            and stamp.read_text().strip() == digest)


def build(build_dir: Path = DEFAULT_BUILD_DIR) -> Path:
    """Compile the kernels unless an up-to-date library exists; return it."""
    build_dir = Path(build_dir)
    library = build_dir / LIBRARY_NAME
    stamp = build_dir / f"{LIBRARY_NAME}.sha256"
    digest = source_digest()
    if _up_to_date(library, digest):
        return library
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    partial = build_dir / f"{LIBRARY_NAME}.{tag}"
    sources = kernel_sources()
    objects = [build_dir / f"{src.stem}.{tag}.o" for src in sources]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o",
                   str(obj), str(src)] for src, obj in zip(sources, objects)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(partial),
                   *map(str, objects)]])
        os.replace(partial, library)
    finally:
        partial.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    stamp.write_text(digest + "\n")
    return library


def find_cxx() -> str:
    """Path of the host C++ compiler: ``$CXX``, then ``c++``, ``g++`` and
    ``clang++`` on PATH."""
    for name in (os.environ.get("CXX"), *CXX_NAMES):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise BuildError(
        "no C++ compiler found (searched $CXX, then "
        f"{', '.join(CXX_NAMES)} on PATH); the host tools of "
        f"{TOOLS_SRC_DIR} cannot be built.")


def tools_digest() -> str:
    """SHA-256 over the flags and every source and header in ``tools/src``."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in sorted([*TOOLS_SRC_DIR.glob("*.cpp"),
                        *TOOLS_SRC_DIR.glob("*.h")]):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()


def tools_built(build_dir: Path = DEFAULT_BUILD_DIR) -> bool:
    """True when ``build_dir`` holds the tools' library stamped with the
    current sources' digest."""
    return _up_to_date(Path(build_dir) / TOOLS_LIBRARY_NAME, tools_digest())


def build_tools(build_dir: Path = DEFAULT_BUILD_DIR) -> Path:
    """Compile the host tools unless an up-to-date library exists; return
    it.  One host-compiler call over ``TOOLS_SOURCES``."""
    build_dir = Path(build_dir)
    library = build_dir / TOOLS_LIBRARY_NAME
    digest = tools_digest()
    if _up_to_date(library, digest):
        return library
    cxx = find_cxx()
    build_dir.mkdir(parents=True, exist_ok=True)
    partial = build_dir / f"{TOOLS_LIBRARY_NAME}.{os.getpid()}.tmp"
    try:
        _run_all([[cxx, *CXX_FLAGS, "-I", str(TOOLS_SRC_DIR), "-o",
                   str(partial),
                   *(str(TOOLS_SRC_DIR / name) for name in TOOLS_SOURCES)]])
        os.replace(partial, library)
    finally:
        partial.unlink(missing_ok=True)
    library.with_name(f"{library.name}.sha256").write_text(digest + "\n")
    return library


def _run_all(commands: list[list[str]]) -> None:
    """Run the commands at once, wait for every one, raise on any failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in commands]
    failures = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{Path(cmd[0]).name} failed "
                            f"(rc={proc.returncode}): "
                            f"{' '.join(cmd)}\n{out}\n{err}")
    if failures:
        raise BuildError("\n".join(failures))


def load_library(build_dir: Path = DEFAULT_BUILD_DIR) -> ctypes.CDLL:
    """The kernel library with its C signatures set.

    The first call in a process for a build directory builds if needed and
    loads; later calls return the loaded library without touching the
    disk, so a launch costs no file I/O.  The key is the path as given:
    resolving it is a filesystem call per component, which measured
    126 µs a launch on the GPU machine.
    """
    key = os.fspath(build_dir)
    if key not in _LOADED:
        lib = ctypes.CDLL(str(build(build_dir)))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LOADED[key] = lib
    return _LOADED[key]


#: The devices the entry points run on: the card, or the plain versions on
#: the host when the caller asks for them.
DEVICES = ("cuda", "cpu")


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device`` for ``device``; raises if it is CUDA and there is none."""
    device = torch.device(device)
    if device.type not in DEVICES:
        raise ValueError(f"Unsupported device={device}; expected {DEVICES}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device=\"cpu\" (--device cpu on the command line) "
            "to run the plain versions on the host."
        )
    return device


def as_rows(x, dtype: torch.dtype | None = None) -> torch.Tensor:
    """An entry point's samples as a tensor, cast to ``dtype`` where given.

    A torch tensor keeps its device: a CPU tensor runs the plain versions.
    Anything else (a numpy array, a list) goes to the card, through
    :func:`resolve_device`, which raises without CUDA and names
    ``device="cpu"``: no entry runs a host array on the host unasked, as
    the JAX functions put one on their accelerator.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=resolve_device("cuda"))
    return x if dtype is None else x.to(dtype)


def check_rows(x: torch.Tensor, dtypes: tuple[torch.dtype, ...]) -> None:
    """Raise unless ``x`` is a 2-D tensor of one of ``dtypes`` on the CPU
    or a GPU."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}; use cpu or cuda")
    if x.dtype not in dtypes:
        raise TypeError(f"expected samples of {dtypes}, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"expected (B, N) rows, got shape {tuple(x.shape)}")


def check_rows_u8(x: torch.Tensor) -> None:
    """Raise unless ``x`` is a 2-D uint8 tensor on the CPU or a GPU."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}; use cpu or cuda")
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8 samples, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"expected (B, N) rows, got shape {tuple(x.shape)}")


def check_launchable(x: torch.Tensor) -> None:
    """Raise unless ``x`` can be handed to a kernel as (B, N) uint8 rows."""
    check_rows_u8(x)
    if x.device.type != "cuda":
        raise ValueError(f"kernel input must be a CUDA tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("kernel input must be contiguous")


def check_same_device(x: torch.Tensor, buffer: torch.Tensor,
                      what: str) -> None:
    if buffer.device != x.device:
        raise ValueError(f"{what} on {buffer.device}, samples on {x.device}")


def check_launch(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    if code != 0:
        message = lib.wft_error_string(code).decode(errors="replace")
        raise LaunchError(f"{kernel} launch failed: CUDA error {code}: "
                          f"{message}")


def stream_of(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
