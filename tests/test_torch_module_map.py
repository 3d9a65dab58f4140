"""The port covers every module of the JAX package, name by name.

Every ``.py`` module of ``warmup_fir_filter_tpu/`` has a counterpart in
``warmup_fir_filter_tpu_torch/`` under the same relative path, except the
six TPU kernel files, which map through ``KERNEL_FILES``.  Every public
top-level name a JAX module defines (``def``, ``class`` or assignment; read
with ``ast``, so neither package is imported and third-party imports such
as ``pl``, ``Mesh`` or ``partial`` are not names the module defines)
exists in its counterpart, defined there or imported from the port's own
modules.  Two kinds of name may differ: ``*_jnp`` entries are ``*_torch``
in the port, and each name of ``EXEMPT`` carries its reason.
"""

import ast
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
JAX_ROOT = REPO_ROOT / "warmup_fir_filter_tpu"
PORT_ROOT = REPO_ROOT / "warmup_fir_filter_tpu_torch"

#: TPU kernel files → the port's kernel modules that take their place.
KERNEL_FILES = {
    "kernels/fir_mxu.py": ("kernels/fir_band.py", "kernels/fir_window.py"),
    "kernels/fir_pallas.py": ("kernels/fir_direct.py",),
    "kernels/fir_float_mxu.py": ("kernels/fir_float.py",),
    "kernels/resample_mxu.py": ("kernels/resample.py",),
    "kernels/fir2d_mxu.py": ("kernels/fir2d.py",),
    "kernels/fft_pallas.py": ("kernels/fft.py",),
}

_TPU_BLOCKING = ("a TPU blocking constant (VMEM budget, lane tiles or rows "
                 "per grid step); the CUDA kernels pick their own")
#: (JAX module, name) → why the port has no such name.
EXEMPT = {
    ("cli.py", "DEFAULT_IMAGE_DIR"):
        "a path on the reference machine; the port's --image-dir has no "
        "default",
    ("utils/profiling.py", "DEFAULT_SOL_MSPS"):
        "a TPU v5e speed of light; the port's StageTimer takes none by "
        "default",
    ("kernels/chain_fused.py", "FUSED_FOLD"):
        "do not port: the TPU fold knob of the fused chain",
    ("kernels/chain_fused.py", "atan2_poly"):
        "do not port: Mosaic has no atan2; kernel J calls atan2f",
    ("kernels/fir_mxu.py", "build_band_matrices"):
        "do not port: the MXU's tri-tile band operands; kernel A builds its "
        "own digit planes",
    ("ops/streaming.py", "auto_rows_split"):
        "do not port: the TPU row-split step; rows_split is accepted and "
        "runs the default step",
    ("kernels/fft_pallas.py", "VMEM_BUDGET_BYTES"): _TPU_BLOCKING,
    ("kernels/fir_pallas.py", "VMEM_BUDGET_BYTES"): _TPU_BLOCKING,
    ("kernels/fir_float_mxu.py", "WIDE_BLOCK_BYTES"): _TPU_BLOCKING,
    ("kernels/fir_float_mxu.py", "WIDE_SEG_TILES"): _TPU_BLOCKING,
    ("kernels/fir_float_mxu.py", "WIDE_UNROLL_TILES"): _TPU_BLOCKING,
    ("kernels/fir_mxu.py", "DEFAULT_BLOCK_ROWS"): _TPU_BLOCKING,
    ("kernels/fir_mxu.py", "DEFAULT_COL_TILES"): _TPU_BLOCKING,
    ("kernels/fir_mxu.py", "FULLROW_BLOCK_BYTES"): _TPU_BLOCKING,
    ("kernels/fir_mxu.py", "MAX_FULLROW_LANES"): _TPU_BLOCKING,
    ("kernels/fir_mxu.py", "MAX_TAPS_TWO_TILE"): _TPU_BLOCKING,
    ("kernels/fir_mxu.py", "MAX_TAPS_WINDOWED"):
        _TPU_BLOCKING + "; the port keeps the same 4,096-tap route "
        "boundary as kernels/fir_window.py::MAX_TAPS",
    ("kernels/resample_mxu.py", "MAX_OUT_TILES"): _TPU_BLOCKING,
}


def jax_modules() -> list[str]:
    return sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py"))


def counterparts(module: str) -> tuple[str, ...]:
    return KERNEL_FILES.get(module, (module,))


def _bound_names(body, own_imports: bool) -> set[str]:
    names: set[str] = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {n.id for target in node.targets
                      for n in ast.walk(target) if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.If, ast.Try)):
            for block in (node.body, node.orelse,
                          getattr(node, "finalbody", []),
                          *(h.body for h in getattr(node, "handlers", []))):
                names |= _bound_names(block, own_imports)
        elif (own_imports and isinstance(node, ast.ImportFrom)
              and (node.module or "").startswith(PORT_ROOT.name)):
            names |= {alias.asname or alias.name for alias in node.names}
    return names


def public_names(path: Path, *, own_imports: bool = False) -> set[str]:
    """Public top-level names ``path`` defines (and, with ``own_imports``,
    imports from the port's own modules)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n for n in _bound_names(tree.body, own_imports)
            if not n.startswith("_")}


def port_name(name: str) -> str:
    return name[: -len("_jnp")] + "_torch" if name.endswith("_jnp") else name


def test_the_jax_package_has_the_modules_the_map_names():
    modules = jax_modules()
    assert len(modules) == 50
    assert set(KERNEL_FILES) <= set(modules)
    for module, name in EXEMPT:
        assert module in modules, module
        assert name in public_names(JAX_ROOT / module), (module, name)


@pytest.mark.parametrize("module", jax_modules())
def test_module_has_a_counterpart(module):
    for target in counterparts(module):
        assert (PORT_ROOT / target).is_file(), (
            f"{module}: no counterpart {target} in the port")


@pytest.mark.parametrize("module", jax_modules())
def test_public_names_exist_in_the_counterpart(module):
    port = set()
    for target in counterparts(module):
        port |= public_names(PORT_ROOT / target, own_imports=True)
    missing = sorted(
        name for name in public_names(JAX_ROOT / module)
        if (module, name) not in EXEMPT and port_name(name) not in port)
    assert not missing, f"{module}: the port lacks {missing}"


@pytest.mark.parametrize("key", sorted(EXEMPT), ids="{0[0]}:{0[1]}".format)
def test_each_exemption_is_needed_and_has_a_reason(key):
    module, name = key
    assert len(EXEMPT[key]) > 20
    port = set()
    for target in counterparts(module):
        port |= public_names(PORT_ROOT / target, own_imports=True)
    assert port_name(name) not in port, f"{key} is ported: drop the exemption"


def test_renames_are_the_jnp_entries():
    renamed = {(module, name) for module in jax_modules()
               for name in public_names(JAX_ROOT / module)
               if port_name(name) != name}
    assert renamed == {("ops/fir1d.py", "fir1d_fixed_rows_jnp"),
                       ("ops/fir1d.py", "fir1d_ideal_rows_jnp"),
                       ("ops/fir2d.py", "fir2d_fixed_jnp"),
                       ("ops/fir2d.py", "fir2d_ideal_jnp")}
