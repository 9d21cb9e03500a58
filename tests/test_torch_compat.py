"""The port's ``compat`` (artelib value classes) vs the JAX package's.

1. Mirror: every test of ``tests/test_compat.py`` (17) runs again, as one
   case of a parametrised test, with the port's ``compat`` and its classes
   in place of the JAX package's, so each case still counts.
2. Cross-package equality: the same float64 inputs through
   ``lidar_slam_arvc_tpu.compat`` and ``lidar_slam_arvc_tpu_torch.compat``
   give bit-equal arrays (both call the same numpy operations in the same
   order; one machine, one BLAS).  ``compute_homogeneous_transforms`` is
   fed a pandas DataFrame and the port's ``read_csv`` column dict.
"""

import importlib.util
import inspect
import os

import numpy as np
import pandas as pd
import pytest
from scipy.spatial.transform import Rotation as SR

from lidar_slam_arvc_tpu import compat as ref
from lidar_slam_arvc_tpu_torch import compat as port
from lidar_slam_arvc_tpu_torch.io.formats import read_csv, write_csv

HERE = os.path.dirname(os.path.abspath(__file__))
CLASS_NAMES = ("Euler", "HomogeneousMatrix", "Quaternion", "RotationMatrix",
               "Vector", "Rx", "Ry", "Rz", "R2")


def _reference_tests():
    """tests/test_compat.py, loaded under its own name (not collected here)."""
    spec = importlib.util.spec_from_file_location(
        "_compat_reference_tests", os.path.join(HERE, "test_compat.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_TESTS = _reference_tests()
MIRRORED = [(cls_name, meth)
            for cls_name, cls in vars(REF_TESTS).items()
            if cls_name.startswith("Test") and inspect.isclass(cls)
            for meth in vars(cls) if meth.startswith("test_")]


def test_mirror_covers_every_reference_test():
    assert len(MIRRORED) == 17


@pytest.mark.parametrize("cls_name,meth", MIRRORED,
                         ids=[f"{c}.{m}" for c, m in MIRRORED])
def test_compat_mirror(cls_name, meth, monkeypatch):
    """tests/test_compat.py's case, run on the port's compat."""
    monkeypatch.setattr(REF_TESTS, "compat", port)
    for name in CLASS_NAMES:
        monkeypatch.setattr(REF_TESTS, name, getattr(port, name))
    fn = getattr(getattr(REF_TESTS, cls_name)(), meth)
    if "rng" in inspect.signature(fn).parameters:
        fn(np.random.default_rng(0))
    else:
        fn()


def _R(rng):
    return SR.from_rotvec(rng.normal(size=3)).as_matrix()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b, equal_nan=True), np.abs(a - b).max()


def _both(build):
    """``build(module)`` on both packages' compat."""
    return build(ref), build(port)


def _arr(x):
    return x.toarray() if hasattr(x, "toarray") else getattr(x, "abg", x)


ROTATIONS = {
    "random": lambda rng: _R(rng),
    "gimbal+": lambda rng: ref.Ry(np.pi / 2).toarray(),
    "gimbal-": lambda rng: ref.Ry(-np.pi / 2).toarray() @ ref.Rx(0.3).toarray(),
    "near_pi": lambda rng: SR.from_rotvec([0.0, np.pi - 1e-6, 0.0]).as_matrix(),
    "identity": lambda rng: np.eye(3),
}


@pytest.mark.parametrize("kind", list(ROTATIONS))
def test_rotation_classes_bit_equal(kind):
    rng = np.random.default_rng(3)
    R = ROTATIONS[kind](rng)
    for build in (lambda m: m.RotationMatrix(R).Q(),
                  lambda m: m.RotationMatrix(R).euler()[0],
                  lambda m: m.RotationMatrix(R).euler()[1],
                  lambda m: m.RotationMatrix(R).inv(),
                  lambda m: m.RotationMatrix(R).Q().R(),
                  lambda m: m.RotationMatrix(R).Q().Euler()[1],
                  lambda m: m.Euler(m.RotationMatrix(R).euler()[0]).R(),
                  lambda m: m.Euler(m.RotationMatrix(R).euler()[1]).Q(),
                  lambda m: m.RotationMatrix(R).Q() * m.RotationMatrix(R.T).Q(),
                  lambda m: m.RotationMatrix(R).Q().qconj(),
                  lambda m: m.RotationMatrix(R) * m.RotationMatrix(R),
                  lambda m: m.RotationMatrix(R) * m.Vector([1.0, -2.0, 0.5]),
                  lambda m: m.HomogeneousMatrix([1.0, 2.0, 3.0], m.RotationMatrix(R)).t2v(),
                  lambda m: m.HomogeneousMatrix([1.0, 2.0, 3.0], m.RotationMatrix(R)).t2v(n=3)):
        a, b = _both(build)
        _same(_arr(a), _arr(b))
    a, b = _both(lambda m: m.RotationMatrix(R).det())
    assert a == b


def test_value_classes_bit_equal():
    rng = np.random.default_rng(4)
    th = 0.7
    for fn in ("Rx", "Ry", "Rz", "R2"):
        a, b = _both(lambda m: getattr(m, fn)(th))
        _same(a.toarray(), b.toarray())
    q = rng.normal(size=4)
    pos = rng.normal(size=3).tolist()
    for build in (lambda m: m.Quaternion(q).R(),
                  lambda m: m.Quaternion(q) * 2.5,
                  lambda m: m.Quaternion(q) / 3.0,
                  lambda m: m.Quaternion(q) + m.Quaternion(q[::-1]),
                  lambda m: m.Quaternion(q).homogeneous(),
                  lambda m: m.Vector([1.0, 2.0, 3.0]).cross(m.Vector([0.5, -1.0, 2.0])),
                  lambda m: m.Vector([1.0, 2.0, 3.0]).homogeneous(),
                  lambda m: m.HomogeneousMatrix(),
                  lambda m: m.HomogeneousMatrix(pos, [0.1, 0.2, 0.3]),
                  lambda m: m.HomogeneousMatrix(np.arange(3.0), m.Euler([0.3, -0.2, 1.0]))):
        a, b = _both(build)
        _same(_arr(a), _arr(b))
    a, b = _both(lambda m: m.Quaternion(q).dot(m.Quaternion(q[::-1])))
    assert a == b


def _poses(m, n, seed):
    rng = np.random.default_rng(seed)
    return [m.HomogeneousMatrix(rng.normal(scale=5.0, size=3),
                                m.RotationMatrix(_R(rng))) for _ in range(n)]


def test_trajectory_functions_bit_equal():
    """The list algebra of both packages, from the same poses: relative and
    global transforms with T0 and a GPS lever arm, multiply_by_transform,
    inverses, quaternions, stack and unstack."""
    a_T, b_T = _both(lambda m: _poses(m, 20, 5))
    lever = np.eye(4)
    lever[:3, 3] = [0.3, -0.1, 1.2]
    for build in (
            lambda m, T: m.compute_relative_transformations(T),
            lambda m, T: m.compute_global_transformations(
                m.compute_relative_transformations(T), T[0]),
            lambda m, T: m.compute_global_transformations(
                m.compute_relative_transformations(T), None,
                m.HomogeneousMatrix(lever)),
            lambda m, T: m.multiply_by_transform(T, m.HomogeneousMatrix(lever)),
            lambda m, T: [t.inv() for t in T],
            lambda m, T: [t.Q() for t in T],
            lambda m, T: m.unstack(m.stack(T))):
        _same(np.stack([_arr(x) for x in build(ref, a_T)]),
              np.stack([_arr(x) for x in build(port, b_T)]))
    _same(ref.stack(a_T), port.stack(b_T))


def test_serial_robot_bit_equal():
    def arm(m):
        r = m.SerialRobot(3, np.eye(4))
        r.append(th=0.1, d=0.3, a=1.0, alpha=np.pi / 2)
        r.append(th=0.0, d=0.0, a=0.5, alpha=0.0, link_type="P")
        r.append(th=-0.4, d=0.1, a=0.2, alpha=-np.pi / 2)
        return r.directkinematics(np.array([0.3, 0.2, -1.1]))
    a, b = _both(arm)
    _same(a.toarray(), b.toarray())


def test_compute_homogeneous_transforms_dataframe_and_csv_dict(tmp_path):
    """One table as a pandas DataFrame (both packages) and as the port's
    ``read_csv`` dict of the same CSV (the port only): bit-equal poses."""
    rng = np.random.default_rng(6)
    n = 12
    q = ref.rot_to_quat_np(SR.random(n, random_state=2).as_matrix())
    cols = {"x": rng.normal(size=n), "y": rng.normal(size=n),
            "z": rng.normal(size=n), "qx": q[:, 1], "qy": q[:, 2],
            "qz": q[:, 3], "qw": q[:, 0]}
    path = str(tmp_path / "poses.csv")
    write_csv(path, cols)
    df = pd.read_csv(path, float_precision="round_trip")
    want = ref.stack(ref.compute_homogeneous_transforms(df))
    _same(port.stack(port.compute_homogeneous_transforms(df)), want)
    _same(port.stack(port.compute_homogeneous_transforms(read_csv(path))), want)
