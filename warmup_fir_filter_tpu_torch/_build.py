"""Build the CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` is compiled in one ``nvcc`` call for ``sm_90a`` into
``build/warmup_fir_filter_tpu_torch/libwft_kernels.so`` beside the package,
at first use.  The sources have a plain C interface and include no
PyTorch header, which keeps the build to seconds.  A stamp file beside
the library holds the SHA-256 of the sources and flags; a changed source
rebuilds.  A missing ``nvcc`` or a failed build raises :class:`BuildError`:
nothing falls back to a plain version.

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

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
DEFAULT_BUILD_DIR = PACKAGE_DIR.parent / "build" / "warmup_fir_filter_tpu_torch"
LIBRARY_NAME = "libwft_kernels.so"
#: Where the CUDA toolkit installs by default; searched after CUDA_HOME
#: and PATH.
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_VOIDP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
#: C signature of each entry point: (argtypes, restype).
_SIGNATURES = {
    # x, y, rows, n, digits, planes, taps, exponents (host), bias,
    # needs_wrap, frac_bits, acc_bits, stream
    "wft_fir_band": (
        [_VOIDP, _VOIDP, _LL, _LL, _VOIDP, _INT, _INT, _VOIDP,
         ctypes.c_uint32, _INT, _INT, _INT, _VOIDP],
        _INT,
    ),
    # x, y, rows, n, taps (device int32), num_taps, frac_bits, acc_bits,
    # stream
    "wft_fir_direct": (
        [_VOIDP, _VOIDP, _LL, _LL, _VOIDP, _INT, _INT, _INT, _VOIDP],
        _INT,
    ),
    "wft_error_string": ([_INT], ctypes.c_char_p),
}

#: Loaded libraries by build directory, one per process.
_LOADED: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


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


def build(build_dir: Path = DEFAULT_BUILD_DIR) -> Path:
    """Compile the kernels unless an up-to-date library exists; return it."""
    build_dir = Path(build_dir)
    library = build_dir / LIBRARY_NAME
    stamp = build_dir / f"{LIBRARY_NAME}.sha256"
    digest = source_digest()
    if (library.is_file() and stamp.is_file()
            and stamp.read_text().strip() == digest):
        return library
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    partial = build_dir / f"{LIBRARY_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(partial),
           *map(str, kernel_sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        raise BuildError(
            f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(partial, library)
    stamp.write_text(digest + "\n")
    return library


def load_library(build_dir: Path = DEFAULT_BUILD_DIR) -> ctypes.CDLL:
    """The kernel library with its C signatures set.

    The first call in a process for a build directory builds if needed and
    loads; later calls return the loaded library without touching the
    disk, so a launch costs no file I/O.
    """
    key = str(Path(build_dir).resolve())
    if key not in _LOADED:
        lib = ctypes.CDLL(str(build(build_dir)))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LOADED[key] = lib
    return _LOADED[key]


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


def check_launch(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    if code != 0:
        message = lib.wft_error_string(code).decode(errors="replace")
        raise LaunchError(f"{kernel} launch failed: CUDA error {code}: "
                          f"{message}")


def stream_of(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
