"""Every public name of the JAX package has its counterpart in the port.

The JAX package is read with ``ast``, not imported.  For every module of
``lidar_slam_arvc_tpu/``, each public top-level ``def``/``class`` and each
``__all__`` entry must be one of:

* defined or exported by the port's module at the same path (an attribute
  of the imported ``lidar_slam_arvc_tpu_torch`` module);
* in ``RENAMED``: the port names it otherwise, and has that name;
* in ``NOT_PORTED``: left out by design, each entry with the reason the
  ROADMAP's ground rules give for it.

A name added to the JAX package fails this test until the port follows,
and an entry of either map that no longer applies fails it too.
"""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "lidar_slam_arvc_tpu")

# (module path under the package, JAX name) -> (port name, reason)
RENAMED = {
    ("io/euroc.py", "trajectory_from_df"): (
        "trajectory_from_table", "reads the port's {column: array} tables, not "
        "a pandas DataFrame (the port imports no pandas)"),
    ("graph/solver.py", "lm_drive"): (
        "lm_schedule", "the LM accept/reject schedule driven from the host, "
        "not a jitted lax.while_loop"),
    ("utils/profiling.py", "CompileCounter"): (
        "BuildCounter", "counts the libraries built or loaded per stage "
        "(nvcc, g++), not XLA compilations"),
}

_PALLAS = ("a Pallas TPU kernel wrapper; its kernels are ported by hand as "
           "CUDA for the H100 (PERF.md section 6)")
# (module path under the package, JAX name) -> reason
NOT_PORTED = {
    ("ops/moments_pallas.py", "ball_moments_pallas"):
        _PALLAS + ": K2, ops/moments.py::ball_moments, csrc/ball_moments.cu",
    ("ops/__init__.py", "ball_moments_pallas"):
        _PALLAS + ": K2, ops/moments.py::ball_moments, csrc/ball_moments.cu",
    ("ops/nn_pallas.py", "nn_search_pallas"):
        _PALLAS + ": K1 and K3, ops/nn.py::nn_search, csrc/nn_sweep.cu",
    ("ops/nn_pallas.py", "nn_search_pallas_vals"):
        _PALLAS + ": K4, ops/nn.py::nn_search_vals, csrc/nn_sweep_vals.cu",
    ("utils/profiling.py", "enable_compilation_cache"):
        "a persistent XLA compilation cache for remote compiles (a TPU-only "
        "workaround); the port caches its built libraries in _build/ by the "
        "hash of their sources",
    ("parallel/schur.py", "schur_lm_step_jit"):
        "a jax.jit wrapper of the Schur LM step; the port calls "
        "parallel/schur.py::schur_lm_step in each rank",
    ("parallel/__init__.py", "schur_lm_step_jit"):
        "a jax.jit wrapper of the Schur LM step; the port calls "
        "parallel/schur.py::schur_lm_step in each rank",
}


def _public_names(path: str) -> set:
    """Public top-level defs and classes, and the ``__all__`` entries."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                names.add(node.name)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            names.update(ast.literal_eval(node.value))
    return names


def _reference_modules() -> dict:
    """{path under the package: public names} of every JAX module."""
    out = {}
    for dirpath, _, files in os.walk(REF):
        for name in sorted(files):
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                out[os.path.relpath(path, REF).replace(os.sep, "/")] = _public_names(path)
    return out


MODULES = _reference_modules()


def _port_module(rel: str):
    mod = rel[:-3].replace("/", ".")
    if mod.endswith("__init__"):
        mod = mod[:-len(".__init__")]
    name = "lidar_slam_arvc_tpu_torch" + ("." + mod if mod != "__init__" else "")
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as exc:
        if exc.name != name:
            raise
        return None


def test_reference_is_parsed():
    assert len(MODULES) > 50
    assert len(MODULES["geom/__init__.py"]) == 32
    assert {"Quaternion", "stack", "unstack"} <= MODULES["compat.py"]


@pytest.mark.parametrize("rel", sorted(MODULES))
def test_every_public_name_has_a_counterpart(rel):
    port = _port_module(rel)
    missing = []
    for name in sorted(MODULES[rel]):
        if (rel, name) in NOT_PORTED:
            continue
        want = RENAMED.get((rel, name), (name,))[0]
        if port is None or not hasattr(port, want):
            missing.append(name if want == name else f"{name} -> {want}")
    assert not missing, f"lidar_slam_arvc_tpu_torch/{rel} lacks {missing}"


@pytest.mark.parametrize("entry", sorted(RENAMED) + sorted(NOT_PORTED),
                         ids=lambda e: f"{e[0]}::{e[1]}")
def test_map_entries_still_apply(entry):
    """Each entry names a public name the JAX module still has and that the
    port does not define under that name, and carries its reason."""
    rel, name = entry
    assert name in MODULES.get(rel, ()), entry
    port = _port_module(rel)
    assert port is None or not hasattr(port, name), entry
    reason = RENAMED[entry][1] if entry in RENAMED else NOT_PORTED[entry]
    assert len(reason) > 20
