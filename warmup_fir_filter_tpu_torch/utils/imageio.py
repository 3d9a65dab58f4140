"""Image loading/saving helpers (Pillow-backed, gracefully gated)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

SUPPORTED_IMAGE_EXTS = (".bmp", ".png", ".jpg", ".jpeg")


def _pil_image():
    try:
        from PIL import Image
    except ModuleNotFoundError as exc:  # pragma: no cover
        raise RuntimeError(
            "Pillow is required for image IO but is not installed."
        ) from exc
    return Image


def load_gray_u8(path: Path) -> np.ndarray:
    """Load any supported image as a (H, W) grayscale uint8 matrix."""
    Image = _pil_image()
    with Image.open(path) as img:
        arr = np.asarray(img.convert("L"), dtype=np.uint8)
    if arr.ndim != 2:
        raise ValueError(f"Expected 2D grayscale image, got shape={arr.shape}.")
    return arr


def save_gray_png(path: Path, arr_u8: np.ndarray) -> None:
    """Save a (H, W) uint8 matrix as a grayscale PNG."""
    if arr_u8.ndim != 2 or arr_u8.dtype != np.uint8:
        raise ValueError(
            f"Expected 2D uint8 array, got shape={arr_u8.shape} "
            f"dtype={arr_u8.dtype}."
        )
    Image = _pil_image()
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr_u8, mode="L").save(path)


def iter_image_files(image_dir: Path) -> list[Path]:
    files = [
        p
        for p in image_dir.iterdir()
        if p.is_file() and p.suffix.lower() in SUPPORTED_IMAGE_EXTS
    ]
    return sorted(files, key=lambda p: p.name.lower())
