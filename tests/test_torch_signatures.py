"""The port's functions take the JAX package's parameters, and its string
options the JAX package's values.

``tests/test_torch_module_map.py`` proves that every public name of a JAX
module exists in its counterpart.  This file holds what those names take,
read with ``ast`` through the same map, so neither package is imported:

- every public function, every public method of a public class and every
  public class's constructor (its ``__init__``, or a dataclass's or named
  tuple's fields) present in both packages, a ``*_jnp`` function against
  its ``*_torch`` counterpart.  Each JAX parameter exists in the port, of
  the same kind (positional or keyword-only), and a JAX call by position
  binds the same parameters in the port: the port's positional parameters
  begin with the JAX ones, in the JAX order.  Each parameter the port adds
  is optional.  A default that is a literal (a string, number, bool or
  None) on either side is equal on both, and a JAX parameter with a
  default has one in the port;
- every module-level tuple of strings of a JAX module, such as
  ``FIXED_BACKENDS`` or ``PRECISIONS``, equals its counterpart in the
  port, value for value and in order.

The port departs from the JAX signatures only where ``DROPPED``,
``ADDED_REQUIRED`` or ``DEFAULTS`` say so, each entry keyed by
``(module, function, parameter)`` with its reason; an entry the code no
longer needs fails the test.
"""

import ast
from pathlib import Path
from typing import NamedTuple

import pytest

from test_torch_module_map import (
    JAX_ROOT,
    PORT_ROOT,
    counterparts,
    jax_modules,
    port_name,
)

#: Why the port drops a TPU knob: each names its "Do not port" entry of
#: ROADMAP.md.
_INTERPRET = ("do not port (ROADMAP.md): Pallas's interpret switch; on a "
              "CPU tensor every entry of the port runs its kernel's plain "
              "version")
_BLOCKING = ("do not port (ROADMAP.md): the TPU blockings of the kernels, "
             "a grid or VMEM knob; each CUDA kernel picks its own launch "
             "shape")
_FFT = ("do not port (ROADMAP.md): the FFT kernels' TPU layout and "
        "blocking helpers (block_rows, r_windows); kernels L and M pick "
        "their own")
_FUSED = ("do not port (ROADMAP.md): the fold, opt and seg_tiles knobs of "
          "chain_fused.py; kernel J has one form")
_ABLATE = ("do not port (ROADMAP.md): the ablate= switches of "
           "_fir2d_oframe_kernel, which time parts of the TPU kernel")

#: (JAX module, function, parameter) → why the port has no such parameter.
DROPPED = {
    **{(module, fn, "interpret"): _INTERPRET for module, fn in (
        ("kernels/chain_fused.py", "chain_forward_fused"),
        ("kernels/fft_pallas.py", "fft_rows_pallas"),
        ("kernels/fft_pallas.py", "fir_overlap_save_pallas"),
        ("kernels/fft_pallas.py", "fir_overlap_save_quantized_pallas"),
        ("kernels/fft_pallas.py", "fir_overlap_save_stream"),
        ("kernels/fir2d_mxu.py", "fir2d_fixed_frame"),
        ("kernels/fir2d_mxu.py", "fir2d_fixed_frame_overlap"),
        ("kernels/fir2d_mxu.py", "fir2d_frame_overlap_bf16"),
        ("kernels/fir2d_mxu.py", "fir2d_fixed_mxu"),
        ("kernels/fir_float_mxu.py", "fir1d_ideal_rows_mxu"),
        ("kernels/fir_mxu.py", "fir1d_fixed_rows_mxu"),
        ("kernels/fir_mxu.py", "fir1d_fixed_rows_mxu_window"),
        ("kernels/fir_pallas.py", "fir1d_fixed_rows_pallas"),
        ("kernels/resample_mxu.py", "resample_poly_mxu"),
        ("kernels/window_copy.py", "window_rows_pallas"),
    )},
    **{key: _BLOCKING for key in (
        ("kernels/fir_float_mxu.py", "fir1d_ideal_rows_mxu", "block_rows"),
        ("kernels/fir_float_mxu.py", "fir1d_ideal_rows_mxu", "seg_tiles"),
        ("kernels/fir_float_mxu.py", "fir1d_ideal_rows_mxu", "unroll"),
        ("kernels/fir_mxu.py", "fir1d_fixed_rows_mxu", "block_rows"),
        ("kernels/fir_mxu.py", "fir1d_fixed_rows_mxu", "col_tiles"),
        ("kernels/fir_mxu.py", "fir1d_fixed_rows_mxu_window", "block_rows"),
        ("kernels/fir_mxu.py", "fir1d_fixed_rows_mxu_window",
         "max_row_lanes"),
        ("kernels/fir_pallas.py", "fir1d_fixed_rows_pallas", "block_rows"),
        ("kernels/resample_mxu.py", "build_resample_band", "group"),
        ("kernels/resample_mxu.py", "resample_poly_mxu", "block_rows"),
        ("kernels/resample_mxu.py", "resample_poly_mxu", "group"),
        ("kernels/resample_mxu.py", "resample_poly_mxu", "max_out_tiles"),
        ("kernels/resample_mxu.py", "resample_poly_mxu", "unroll"),
    )},
    **{key: _FFT for key in (
        ("kernels/fft_pallas.py", "fir_overlap_save_pallas", "block_rows"),
        ("kernels/fft_pallas.py", "fir_overlap_save_stream", "r_windows"),
    )},
    **{("kernels/chain_fused.py", "chain_forward_fused", knob): _FUSED
       for knob in ("fold", "opt", "seg_tiles")},
    ("kernels/fir2d_mxu.py", "fir2d_fixed_frame_overlap", "ablate"): _ABLATE,
    ("parallel/mesh.py", "make_mesh", "devices"):
        "a JAX mesh is built over a list of devices; a rank of the port's "
        "process group holds one card, so its mesh spans the group's ranks",
}

_HALO_MESH = ("the JAX function runs inside shard_map, whose mesh names "
              "the neighbours; torch.distributed has no such context, so "
              "the port takes the Mesh of its process group")
#: (JAX module, function, parameter) → why a parameter the port adds is
#: required.
ADDED_REQUIRED = {
    ("parallel/halo.py", "exchange_halo_1d", "mesh"): _HALO_MESH,
    ("parallel/halo.py", "exchange_halo_2d", "mesh"): _HALO_MESH,
}

_AUTO = ("the JAX default, \"tpu\", is the int32 path of torch ops, which "
         "launches no kernel; \"auto\" runs the main path on kernel A (C "
         "or B by tap count), as the JAX package's \"auto\" picks its "
         "Pallas kernels")
#: (JAX module, function, parameter) → why the port's default differs.
DEFAULTS = {
    ("cli.py", "run_pipeline", "backend"): _AUTO,
    ("pipeline/stages.py", "generate_fixed_outputs", "backend"): _AUTO,
    ("utils/profiling.py", "StageTimer", "sol_msps"):
        "DEFAULT_SOL_MSPS is a TPU v5e speed of light; the port's stage "
        "lines carry no speed-of-light fraction unless given one",
}


def _module_path(root: Path, dotted: str) -> Path | None:
    parts = dotted.split(".")[1:]
    for path in (root.joinpath(*parts).with_suffix(".py"),
                 root.joinpath(*parts, "__init__.py")):
        if path.is_file():
            return path
    return None


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _top_level(body):
    """The statements of a module's body, ``if`` and ``try`` blocks
    entered."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            for block in (node.body, node.orelse,
                          getattr(node, "finalbody", []),
                          *(h.body for h in getattr(node, "handlers", []))):
                yield from _top_level(block)
        else:
            yield node


def definitions(path: Path, root: Path | None = None,
                _open: frozenset = frozenset()) -> dict[str, ast.AST]:
    """Public top-level ``def``, ``class`` and assignment nodes of ``path``
    by name (an assignment as its value); with ``root``, also the names
    ``path`` imports from the package at ``root``, resolved to their
    definitions there (``_open``: the modules being read, so that an import
    cycle ends)."""
    found: dict[str, ast.AST] = {}
    for node in _top_level(_parse(path).body):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            found[node.name] = node
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    found[target.id] = node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            found[node.target.id] = node.value
        elif (root is not None and isinstance(node, ast.ImportFrom)
              and (node.module or "").startswith(root.name)):
            source = _module_path(root, node.module)
            if source is None or source in _open | {path}:
                continue
            defs = definitions(source, root, _open | {path})
            for alias in node.names:
                if alias.name in defs:
                    found[alias.asname or alias.name] = defs[alias.name]
    return {name: node for name, node in found.items()
            if not name.startswith("_") and node is not None}


class Param(NamedTuple):
    name: str
    kind: str  # "positional", "keyword", "*args" or "**kwargs"
    default: ast.expr | None


def _params(args: ast.arguments, skip_first: bool) -> list[Param]:
    positional = [*args.posonlyargs, *args.args]
    defaults = [None] * (len(positional) - len(args.defaults)) + list(
        args.defaults)
    params = [Param(a.arg, "positional", d)
              for a, d in zip(positional, defaults)][int(skip_first):]
    if args.vararg:
        params.append(Param(args.vararg.arg, "*args", None))
    params += [Param(a.arg, "keyword", d)
               for a, d in zip(args.kwonlyargs, args.kw_defaults)]
    if args.kwarg:
        params.append(Param(args.kwarg.arg, "**kwargs", None))
    return params


def _decorators(node) -> set[str]:
    names = set()
    for dec in node.decorator_list:
        dec = dec.func if isinstance(dec, ast.Call) else dec
        names.add(dec.attr if isinstance(dec, ast.Attribute)
                  else getattr(dec, "id", ""))
    return names


def _fields(cls: ast.ClassDef) -> list[Param]:
    """A dataclass's or named tuple's fields as keyword-or-positional
    parameters (``field(init=False)`` and ``ClassVar`` left out)."""
    params = []
    for node in cls.body:
        if not (isinstance(node, ast.AnnAssign)
                and isinstance(node.target, ast.Name)):
            continue
        if "ClassVar" in ast.unparse(node.annotation):
            continue
        value = node.value
        if (isinstance(value, ast.Call)
                and getattr(value.func, "id", None) == "field"):
            kw = {k.arg: k.value for k in value.keywords}
            if "init" in kw and ast.literal_eval(kw["init"]) is False:
                continue
            value = kw.get("default", kw.get("default_factory"))
        params.append(Param(node.target.id, "positional", value))
    return params


def signatures(defs: dict[str, ast.AST]) -> dict[str, list[Param]]:
    """``name`` → parameters for each public function, each public class's
    constructor (``Class``) and each public method (``Class.method``)."""
    sigs = {}
    for name, node in defs.items():
        if isinstance(node, ast.FunctionDef):
            sigs[name] = _params(node.args, skip_first=False)
        if not isinstance(node, ast.ClassDef):
            continue
        methods = {m.name: m for m in node.body
                   if isinstance(m, ast.FunctionDef)}
        bases = {ast.unparse(b) for b in node.bases}
        if "__init__" in methods:
            sigs[name] = _params(methods["__init__"].args, skip_first=True)
        elif "dataclass" in _decorators(node) or bases & {
                "NamedTuple", "typing.NamedTuple"}:
            sigs[name] = _fields(node)
        for method, fn in methods.items():
            if method.startswith("_") or "property" in _decorators(fn):
                continue
            sigs[f"{name}.{method}"] = _params(
                fn.args, skip_first="staticmethod" not in _decorators(fn))
    return sigs


def _literal(node: ast.expr | None):
    """``(True, value)`` for a literal default, else ``(False, None)``."""
    if node is None:
        return False, None
    try:
        value = ast.literal_eval(node)
    except ValueError:
        return False, None
    ok = value is None or isinstance(value, (str, int, float, bool))
    return ok, value if ok else None


def _counterpart_defs(module: str) -> dict[str, ast.AST]:
    port: dict[str, ast.AST] = {}
    for target in counterparts(module):
        port.update(definitions(PORT_ROOT / target, PORT_ROOT))
    return port


def signature_gaps(module: str) -> dict[tuple, str]:
    """Every way the port's signatures in ``module``'s counterparts depart
    from the JAX ones, keyed as the exemption dicts are: ``("dropped",
    key)``, ``("added", key)`` or ``("default", key)`` → what differs.
    Kinds and positions that differ have no exemption."""
    jax = signatures(definitions(JAX_ROOT / module))
    port = signatures(_counterpart_defs(module))
    gaps = {}
    for name, jax_params in jax.items():
        port_fn = port_name(name)
        if port_fn not in port:
            continue
        port_params = {p.name: p for p in port[port_fn]}
        jax_names = {p.name for p in jax_params}
        for p in jax_params:
            key = (module, name, p.name)
            q = port_params.get(p.name)
            if q is None:
                gaps["dropped", key] = f"{name}: the port lacks {p.name!r}"
                continue
            if q.kind != p.kind:
                gaps["kind", key] = (f"{name}({p.name}): {p.kind} in JAX, "
                                     f"{q.kind} in the port")
            jax_lit, port_lit = _literal(p.default), _literal(q.default)
            if p.default is not None and q.default is None:
                gaps["default", key] = (
                    f"{name}({p.name}): required in the port, "
                    f"{ast.unparse(p.default)} in JAX")
            elif (jax_lit[0] or port_lit[0]) and jax_lit != port_lit:
                gaps["default", key] = (
                    f"{name}({p.name}): default "
                    f"{ast.unparse(q.default) if q.default else None} in "
                    f"the port, "
                    f"{ast.unparse(p.default) if p.default else None} in JAX")
        shared = [p.name for p in jax_params
                  if p.kind == "positional" and p.name in port_params]
        ported = [q.name for q in port[port_fn] if q.kind == "positional"]
        if ported[: len(shared)] != shared:
            gaps["order", (module, name, None)] = (
                f"{name}: positional {ported} in the port, JAX {shared}")
        for q in port[port_fn]:
            if (q.name not in jax_names and q.default is None
                    and q.kind in ("positional", "keyword")):
                gaps["added", (module, port_fn, q.name)] = (
                    f"{port_fn}: the port adds required {q.name!r}")
    return gaps


def string_tuples(defs: dict[str, ast.AST]) -> dict[str, tuple]:
    """Each name bound to a literal tuple of strings."""
    found = {}
    for name, node in defs.items():
        if isinstance(node, ast.Tuple) and node.elts and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in node.elts):
            found[name] = tuple(e.value for e in node.elts)
    return found


EXEMPTIONS = {"dropped": DROPPED, "added": ADDED_REQUIRED,
              "default": DEFAULTS}


@pytest.mark.parametrize("module", jax_modules())
def test_signatures_match_the_jax_package(module):
    unexplained = {key: why for key, why in signature_gaps(module).items()
                   if key[1] not in EXEMPTIONS.get(key[0], {})}
    assert not unexplained, "\n".join(sorted(unexplained.values()))


@pytest.mark.parametrize("module", jax_modules())
def test_string_tuples_match_the_jax_package(module):
    port_defs = _counterpart_defs(module)
    port = string_tuples(port_defs)
    for name, values in string_tuples(
            definitions(JAX_ROOT / module)).items():
        if name not in port_defs:
            continue  # test_torch_module_map.py holds the name itself
        assert port.get(name) == values, (
            f"{module}:{name} is {values} in JAX, "
            f"{ast.unparse(port_defs[name])} in the port")


_ALL_GAPS = {key for module in jax_modules()
             for key in signature_gaps(module)}


@pytest.mark.parametrize(
    "kind,key",
    sorted((kind, key) for kind, table in EXEMPTIONS.items()
           for key in table),
    ids=lambda v: v if isinstance(v, str) else ":".join(map(str, v)))
def test_each_exemption_is_needed_and_has_a_reason(kind, key):
    assert len(EXEMPTIONS[kind][key]) > 20
    assert (kind, key) in _ALL_GAPS, (
        f"{key} no longer departs from the JAX signature: drop the "
        "exemption")
