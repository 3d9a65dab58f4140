"""Content-addressed artifact store with the reference's naming contracts.

The filesystem *is* the inter-stage transport and resume point of the
verification flow (SURVEY.md §1, §5.4).  This module centralizes every
naming convention, pairing regex, and idempotent-skip rule that the
reference scatters across its five generator scripts:

- input vectors   ``case_{idx:03d}_{stem}_x_u8.npy``  (+ preview JSON,
  global manifest)             — ``gen_input_vectors.py:122-168``
- ideal outputs   ``{case}__{coeff}_ideal_{N}tap_y_f64.npy``
                               — ``gen_ideal_output.py:80-99``
- fixed outputs   ``{case}__{coeff}_fixed_{N}tap_y_u8.npy``
                               — ``gen_fixed_output.py:93-121``
- pairing regexes as the report/restore keys
                               — ``gen_5tap_compare_report.py:24-25``,
                                 ``restore_images.py:34-36``
- restored images ``output_img/{kind}_{N}tap[_{policy}]/*.png``
                               — ``restore_images.py:98-101``
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

INPUT_SUFFIX = "_x_u8.npy"

#: Parses any output vector filename into (case_stem, coeff_name, kind, tap,
#: dtype_tag) — the universal pairing key.
OUTPUT_NAME_RE = re.compile(
    r"^(?P<case_stem>.+?)__(?P<coeff_name>.+)_(?P<kind>ideal|fixed)"
    r"_(?P<tap>\d+)tap_y_(?P<dtype_tag>f64|u8)\.npy$"
)

VALID_KINDS = ("ideal", "fixed")
KIND_DTYPE_TAG = {"ideal": "f64", "fixed": "u8"}


@dataclass(frozen=True)
class OutputKey:
    case_stem: str
    coeff_name: str

    def __str__(self) -> str:
        return f"{self.case_stem}__{self.coeff_name}"


def parse_output_name(name: str):
    """Parse an output vector filename; returns a match dict or None."""
    m = OUTPUT_NAME_RE.match(name)
    if m is None:
        return None
    return m.groupdict()


class ArtifactStore:
    """Paths + naming + idempotency for one pipeline artifact tree.

    Layout (rooted at ``root``)::

        input/                          input vectors + previews + manifest
        output/ideal_{N}tap/            float64 ideal outputs
        output/fixed_{N}tap/            uint8 fixed outputs
        report_{N}tap/                  compare reports (csv + json)
        output_img/{kind}_{N}tap[_{policy}]/   restored PNGs
    """

    def __init__(self, root: Path | str):
        self.root = Path(root).resolve()

    # -- directories -------------------------------------------------------
    @property
    def input_dir(self) -> Path:
        return self.root / "input"

    @property
    def output_dir(self) -> Path:
        return self.root / "output"

    def vector_dir(self, kind: str, tap: int) -> Path:
        if kind not in VALID_KINDS:
            raise ValueError(f"Unsupported kind={kind!r}; expected {VALID_KINDS}")
        return self.output_dir / f"{kind}_{tap}tap"

    def report_dir(self, tap: int) -> Path:
        return self.root / f"report_{tap}tap"

    def restored_dir(self, kind: str, tap: int, *, ideal_policy: str = "clip") -> Path:
        # Non-default ideal policies get their own directory
        # (restore_images.py:98-101).
        sub = f"{kind}_{tap}tap"
        if kind == "ideal" and ideal_policy != "clip":
            sub = f"{sub}_{ideal_policy}"
        return self.root / "output_img" / sub

    # -- filenames ---------------------------------------------------------
    @staticmethod
    def case_name(index: int, image_stem: str) -> str:
        return f"case_{index:03d}_{image_stem}"

    def input_vector_path(self, case_name: str) -> Path:
        return self.input_dir / f"{case_name}{INPUT_SUFFIX}"

    def input_preview_path(self, case_name: str) -> Path:
        return self.input_dir / f"{case_name}_preview.json"

    def manifest_path(self) -> Path:
        return self.input_dir / "input_vector_manifest.json"

    def output_vector_path(
        self, kind: str, tap: int, case_stem: str, coeff_name: str
    ) -> Path:
        tag = KIND_DTYPE_TAG[kind]
        return (
            self.vector_dir(kind, tap)
            / f"{case_stem}__{coeff_name}_{kind}_{tap}tap_y_{tag}.npy"
        )

    # -- enumeration -------------------------------------------------------
    def iter_input_vectors(self) -> list[Path]:
        if not self.input_dir.exists():
            return []
        return sorted(
            (p for p in self.input_dir.glob(f"*{INPUT_SUFFIX}") if p.is_file()),
            key=lambda p: p.name.lower(),
        )

    @staticmethod
    def case_stem_of_input(path: Path) -> str:
        name = path.name
        if name.endswith(INPUT_SUFFIX):
            return name[: -len(INPUT_SUFFIX)]
        return path.stem

    def collect_output_vectors(
        self, kind: str, tap: int
    ) -> tuple[dict[OutputKey, Path], list[str], list[str]]:
        """Enumerate {key: path} for one output dir, with validation.

        Returns (key→path, invalid_filenames, duplicate_keys) — the same
        triple the reference's ``_collect_keyed_files`` produces
        (``gen_5tap_compare_report.py:43-64``).
        """
        directory = self.vector_dir(kind, tap)
        key_to_path: dict[OutputKey, Path] = {}
        invalid: list[str] = []
        duplicates: list[str] = []
        expected_tag = KIND_DTYPE_TAG[kind]
        if not directory.exists():
            return key_to_path, invalid, duplicates
        for path in sorted(
            (p for p in directory.glob("*.npy") if p.is_file()),
            key=lambda p: p.name.lower(),
        ):
            parsed = parse_output_name(path.name)
            if (
                parsed is None
                or parsed["kind"] != kind
                or int(parsed["tap"]) != tap
                or parsed["dtype_tag"] != expected_tag
            ):
                invalid.append(path.name)
                continue
            key = OutputKey(parsed["case_stem"], parsed["coeff_name"])
            if key in key_to_path:
                duplicates.append(str(key))
                continue
            key_to_path[key] = path
        return key_to_path, invalid, sorted(duplicates)

    # -- idempotency -------------------------------------------------------
    @staticmethod
    def should_skip(path: Path, *, overwrite: bool) -> bool:
        """Skip-if-exists semantics (resume point, SURVEY.md §5.4)."""
        return path.exists() and not overwrite


def write_json(path: Path, payload: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        json.dumps(payload, indent=2, ensure_ascii=False) + "\n",
        encoding="utf-8",
    )


def save_npy(path: Path, arr: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, arr)
