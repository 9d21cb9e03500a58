"""Every public callable of the JAX package takes the port's parameters.

``test_torch_api_coverage.py`` holds each public name of the JAX package to
a counterpart in the port.  This file goes one level down.  The JAX package
is read with ``ast``, not imported.  For every module, it takes:

* each public top-level function: its parameter names and their defaults;
* each public class: the parameters of its ``__init__``, the fields of a
  NamedTuple or dataclass with their defaults, and each public method
  (``classmethod`` and ``staticmethod`` included) with its parameters;

and holds each to the port's counterpart, read with ``inspect.signature``
(a NamedTuple's ``_fields``, a dataclass's ``fields``):

* the port has every parameter, under the same name;
* where the JAX package gives a literal default (a number, a string, None,
  a tuple of them), the port gives the same value of the same type; a
  default named by a constant or built by a call need only exist;
* the JAX package's positional parameters begin the port's, in order, up
  to the first one that a map below renames or leaves out, so that a
  positional call means the same in both.

The port may add parameters after those.  Each deliberate difference sits
in a map with its reason: ``PARAM_RENAMED`` and ``PARAM_NOT_PORTED`` name a
parameter, ``DEFAULT_CHANGED`` a default, ``METHOD_RENAMED`` a method; the
``test_*_entries_still_apply`` cases fail once an entry no longer applies.
The names that ``test_torch_api_coverage.py``'s maps rename or leave out,
and the Pallas modules (``ops/nn_pallas.py``, ``ops/moments_pallas.py``),
stay out.
"""

import ast
import dataclasses
import importlib
import inspect
import os

import pytest

from test_torch_api_coverage import NOT_PORTED, RENAMED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "lidar_slam_arvc_tpu")
PORT = "lidar_slam_arvc_tpu_torch"

SKIPPED_MODULES = {
    "ops/nn_pallas.py":
        "Pallas TPU kernel wrappers; their kernels are ported by hand as CUDA "
        "(test_torch_api_coverage.py NOT_PORTED)",
    "ops/moments_pallas.py":
        "a Pallas TPU kernel wrapper; its kernel is ported by hand as CUDA "
        "(test_torch_api_coverage.py NOT_PORTED)",
}

_RNG = ("jax.random keys become CPU torch.Generators, which the port's "
        "draws come from (ops/draws.py; ROADMAP Queue 3, RNG)")
_TABLE = ("pandas DataFrames become the port's {column: array} tables (the "
          "port imports no pandas)")
_TILE = ("a Pallas TPU tile knob; the CUDA kernels pick their own tiles and "
         "grid from the shapes and the card (ops/_cuda.py)")
_INTERPRET = ("Pallas interpret mode, a TPU-kernel debugging aid; a CPU tensor "
              "takes the kernel's plain version instead")
_CHAIN = ("the TPU solver layout (graph/solver.py:274-294 lays the chain slots "
          "as a tiled band with no scatter), which ROADMAP's ground rules leave out")

# (module, qualified callable, JAX parameter) -> (port parameter, reason)
PARAM_RENAMED = {
    ("cloud/plane.py", "ransac_ground_plane", "key"): ("generator", _RNG),
    ("pipeline/preprocess.py", "preprocess_batch", "keys"): ("generators", _RNG),
    ("registration/global_reg.py", "global_registration", "key"): ("generator", _RNG),
    ("registration/global_reg.py", "ransac_feature_registration", "key"):
        ("generator", _RNG),
    ("io/euroc.py", "EurocDataset.get_df_at_times", "df_data"): ("table", _TABLE),
    ("io/sampling.py", "sample_odometry", "df_odo"): ("odo", _TABLE),
    ("io/utm.py", "gps2utm", "df_gps"): ("gps", _TABLE),
    ("io/utm.py", "filter_gps", "df_gps"): ("gps", _TABLE),
    ("pipeline/scanmatcher.py", "relative_odometry", "df_odo"): ("odo", _TABLE),
    ("viz/plots.py", "plot_gps_comparison", "df_gps"): ("gps", _TABLE),
    ("viz/plots.py", "plot_gps_osm", "df_gps"): ("gps", _TABLE),
    ("viz/plots.py", "plot_gps_points", "df_gps"): ("gps", _TABLE),
    ("viz/plots.py", "plot_utm_points", "df_utm"): ("utm", _TABLE),
    ("viz/plots.py", "plot_quaternion_data", "df_data"): ("data", _TABLE),
    ("viz/plots.py", "plot_xyz_data", "df_data"): ("data", _TABLE),
    ("viz/plots.py", "plot_xy_data", "df_data"): ("data", _TABLE),
}

# (module, qualified callable, JAX parameter) -> reason
PARAM_NOT_PORTED = {
    ("cloud/fpfh.py", "compute_fpfh", "query_block"): _TILE,
    ("cloud/fpfh.py", "compute_fpfh", "tgt_block"): _TILE,
    ("ops/nn.py", "nn_search", "src_block"): _TILE,
    ("ops/nn.py", "nn_search", "tgt_block"): _TILE,
    ("ops/nn.py", "nn2_search", "tgt_block"): _TILE,
    ("ops/nn_pruned.py", "nn_search_pruned", "interpret"): _INTERPRET,
    ("ops/nn_pruned.py", "nn_search_pruned_presorted", "interpret"): _INTERPRET,
    ("graph/solver.py", "solve_graph", "chain_capacity"): _CHAIN,
    ("graph/solver.py", "marginal_covariances", "chain_capacity"): _CHAIN,
    ("keyframes/store.py", "KeyframeStore.shard", "axis"):
        "the port's mesh is a torch.distributed process group, one rank per "
        "device, with no named axes (ROADMAP, Multi-device design)",
}

# (module, qualified callable, JAX parameter) -> (port default, reason)
DEFAULT_CHANGED = {
    ("viz/viewer.py", "view_dataset", "keyframe_sampling"): (
        None, "None reads visualization_keyframe_sampling from the slam "
        "parameters, where the JAX package hardcodes 10 (ROADMAP Queue 3, "
        "handled in ported code)"),
}

# (module, class, JAX method) -> (port method, reason)
METHOD_RENAMED = {
    ("io/euroc.py", "EurocDataset", "get_df_at_times"): (
        "get_rows_at_times", "selects rows of the port's {column: array} "
        "tables, not of a pandas DataFrame"),
}

COVERAGE_MAPPED = set(RENAMED) | set(NOT_PORTED)

_MISSING = object()   # a parameter without a default
_OPAQUE = object()    # a default that is not a literal


# ------------------------------------------------------------ the JAX side

def _literal(node):
    if node is None:
        return _MISSING
    try:
        return ast.literal_eval(node)
    except ValueError:
        return _OPAQUE


def _decorators(node) -> set:
    out = set()
    for d in node.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        out.add(d.attr if isinstance(d, ast.Attribute) else getattr(d, "id", ""))
    return out


def _function_params(node, drop_first: bool) -> list:
    """[(name, kind, default)] of a ``def``: kind is "pos" for a parameter a
    caller may pass by position, "kw" for a keyword-only one."""
    a = node.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = [(p.arg, "pos", _literal(d)) for p, d in zip(pos, defaults)]
    if drop_first:
        out = out[1:]
    out += [(p.arg, "kw", _literal(d)) for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    return out


def _field_params(node) -> list:
    """The fields of a NamedTuple or dataclass body, in order, as "pos"."""
    out = []
    for stmt in node.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            if "ClassVar" in ast.unparse(stmt.annotation):
                continue
            default = _literal(stmt.value)
            if (isinstance(stmt.value, ast.Call)
                    and ast.unparse(stmt.value.func).endswith("field")):
                default = _OPAQUE
            out.append((stmt.target.id, "pos", default))
    return out


def _is_record(node) -> str | None:
    bases = {ast.unparse(b) for b in node.bases}
    if bases & {"NamedTuple", "typing.NamedTuple"}:
        return "namedtuple"
    if "dataclass" in _decorators(node):
        return "dataclass"
    return None


def _reference_callables(path: str) -> dict:
    """{qualified name: [(name, kind, default)]} of a JAX module's public
    functions, constructors, records and methods."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = {}
    for node in tree.body:
        if node.name.startswith("_") if hasattr(node, "name") else True:
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _function_params(node, drop_first=False)
        elif isinstance(node, ast.ClassDef):
            record = _is_record(node)
            if record:
                out[node.name] = _field_params(node)
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                decos = _decorators(item)
                if item.name == "__init__" and not record:
                    out[node.name] = _function_params(item, drop_first=True)
                elif (not item.name.startswith("_") and "property" not in decos
                      and "setter" not in decos):
                    out[f"{node.name}.{item.name}"] = _function_params(
                        item, drop_first="staticmethod" not in decos)
    return out


def _reference_modules() -> dict:
    out = {}
    for dirpath, _, files in os.walk(REF):
        for name in sorted(files):
            rel = os.path.relpath(os.path.join(dirpath, name), REF).replace(os.sep, "/")
            if name.endswith(".py") and rel not in SKIPPED_MODULES:
                out[rel] = _reference_callables(os.path.join(dirpath, name))
    return out


MODULES = _reference_modules()


# ----------------------------------------------------------- the port side

def _port_module(rel: str):
    mod = rel[:-3].replace("/", ".")
    if mod == "__init__":
        return importlib.import_module(PORT)
    return importlib.import_module(PORT + "." + mod.removesuffix(".__init__"))


def _port_callable(module, rel: str, qualname: str):
    """The port's object for a JAX qualified name, and whether its first
    parameter (self, cls) is to be dropped; None when it is missing."""
    cls_name, _, method = qualname.partition(".")
    obj = getattr(module, cls_name, None)
    if obj is None or not method:
        return obj, False
    method = METHOD_RENAMED.get((rel, cls_name, method), (method,))[0]
    try:
        attr = inspect.getattr_static(obj, method)
    except AttributeError:
        return None, False
    if isinstance(attr, staticmethod):
        return attr.__func__, False
    if isinstance(attr, classmethod):
        return attr.__func__, True
    return attr, True


def _port_params(obj, drop_first: bool) -> list:
    """[(name, kind, default)] of the port's callable, in order."""
    if inspect.isclass(obj) and hasattr(obj, "_fields"):        # NamedTuple
        return [(f, "pos", obj._field_defaults.get(f, _MISSING))
                for f in obj._fields]
    if inspect.isclass(obj) and dataclasses.is_dataclass(obj):
        out = []
        for f in dataclasses.fields(obj):
            d = f.default
            if d is dataclasses.MISSING:
                d = _OPAQUE if f.default_factory is not dataclasses.MISSING else _MISSING
            out.append((f.name, "pos" if not f.kw_only else "kw", d))
        return out
    sig = inspect.signature(obj.__init__ if inspect.isclass(obj) else obj)
    params = list(sig.parameters.values())
    if drop_first or inspect.isclass(obj):
        params = params[1:]
    kinds = {inspect.Parameter.POSITIONAL_ONLY: "pos",
             inspect.Parameter.POSITIONAL_OR_KEYWORD: "pos",
             inspect.Parameter.KEYWORD_ONLY: "kw"}
    return [(p.name, kinds.get(p.kind, "var"),
             _MISSING if p.default is inspect.Parameter.empty else p.default)
            for p in params]


def _mapped(key) -> bool:
    return key in PARAM_RENAMED or key in PARAM_NOT_PORTED


def _differences(rel: str, qualname: str, ref: list, port: list) -> list:
    have = {name: (kind, default) for name, kind, default in port}
    out = []
    # the JAX package's positional parameters lead the port's, in order, up
    # to the first one the port renames or leaves out: past it a positional
    # call of the JAX package cannot carry over (its value has another type
    # in the port, or no place there)
    prefix = []
    for name, kind, _ in ref:
        if kind != "pos" or _mapped((rel, qualname, name)):
            break
        prefix.append(name)
    positional = [name for name, kind, _ in port if kind == "pos"]
    if positional[:len(prefix)] != prefix:
        out.append(f"{qualname}: positional {positional} do not begin with "
                   f"the JAX package's {prefix}")
    for name, kind, default in ref:
        key = (rel, qualname, name)
        if key in PARAM_NOT_PORTED:
            continue
        want = PARAM_RENAMED.get(key, (name,))[0]
        if want not in have:
            out.append(f"{qualname}: lacks {name!r}"
                       + (f" (as {want!r})" if want != name else ""))
            continue
        port_kind, port_default = have[want]
        if kind == "pos" and port_kind != "pos" and default is _MISSING:
            out.append(f"{qualname}: {want!r} is keyword-only in the port")
        if key in DEFAULT_CHANGED:
            default = DEFAULT_CHANGED[key][0]
        if default is _MISSING:
            continue    # the port may default what the JAX package requires
        if port_default is _MISSING:
            out.append(f"{qualname}: {want!r} has no default (JAX: {default!r})")
        elif default is not _OPAQUE and not (
                type(port_default) is type(default) and port_default == default):
            out.append(f"{qualname}: {want!r} defaults to {port_default!r} "
                       f"(JAX: {default!r})")
    return out


def _callables(rel: str):
    """(qualified name, JAX parameters) of a module, less the names that
    test_torch_api_coverage.py's maps rename or leave out (they are other
    callables in the port, or none, each with its reason there)."""
    for qualname, ref in sorted(MODULES[rel].items()):
        if (rel, qualname.partition(".")[0]) not in COVERAGE_MAPPED:
            yield qualname, ref


def test_reference_is_parsed():
    store = MODULES["keyframes/store.py"]
    assert [p[0] for p in store["KeyframeStore.from_arrays"]][-1] == "icp_params"
    assert store["KeyframeStore.load_and_preprocess"] == [
        ("keyframe_sampling", "pos", 1), ("seed", "pos", 0)]
    fields = MODULES["registration/icp.py"]["ICPResult"]
    assert fields[-2:] == [("iterations", "pos", 0), ("final_delta", "pos", 0.0)]
    assert "EurocDataset.get_closest_times" in MODULES["io/euroc.py"]
    assert sum(len(m) for m in MODULES.values()) > 250


@pytest.mark.parametrize("rel", sorted(MODULES))
def test_every_public_signature_matches(rel):
    port = _port_module(rel)
    problems = []
    for qualname, ref in _callables(rel):
        obj, drop_first = _port_callable(port, rel, qualname)
        if obj is None:
            problems.append(f"{qualname}: missing")
            continue
        problems += _differences(rel, qualname, ref, _port_params(obj, drop_first))
    assert not problems, f"{PORT}/{rel}:\n  " + "\n  ".join(problems)


def _entry_id(entry):
    return "::".join(entry)


@pytest.mark.parametrize("entry", sorted(PARAM_RENAMED) + sorted(PARAM_NOT_PORTED)
                         + sorted(DEFAULT_CHANGED), ids=_entry_id)
def test_param_entries_still_apply(entry):
    """Each entry names a parameter the JAX callable still has; the port
    does not take it under that name (renamed, left out) or takes it with
    the recorded default, which is not the JAX package's; and each carries
    its reason."""
    rel, qualname, name = entry
    ref = {n: d for n, _, d in MODULES[rel][qualname]}
    assert name in ref, entry
    obj, drop_first = _port_callable(_port_module(rel), rel, qualname)
    port = {n: d for n, _, d in _port_params(obj, drop_first)}
    if entry in DEFAULT_CHANGED:
        default, reason = DEFAULT_CHANGED[entry]
        assert port[name] == default and ref[name] != default, entry
    else:
        assert name not in port, entry
        reason = PARAM_NOT_PORTED.get(entry)
        if entry in PARAM_RENAMED:
            new, reason = PARAM_RENAMED[entry]
            assert new in port, entry
    assert len(reason) > 20


@pytest.mark.parametrize("entry", sorted(METHOD_RENAMED), ids=_entry_id)
def test_method_entries_still_apply(entry):
    rel, cls, name = entry
    assert f"{cls}.{name}" in MODULES[rel], entry
    port_cls = getattr(_port_module(rel), cls)
    new, reason = METHOD_RENAMED[entry]
    assert hasattr(port_cls, new) and not hasattr(port_cls, name), entry
    assert len(reason) > 20
