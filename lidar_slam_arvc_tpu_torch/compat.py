"""artelib-compatible value classes for users migrating from the reference.

Counterpart of ``lidar_slam_arvc_tpu/compat.py``, the port's own copy: the
same classes and functions over the same numpy float64 operations, in the
same order, so both packages give bit-equal arrays on one machine.

The framework's native geometry API is functional and batched
(``lidar_slam_arvc_tpu_torch.geom`` on tensors, ``geom.hostmath`` numpy
mirrors).  Reference users, however, hold poses as ``artelib`` objects —
``HomogeneousMatrix``, ``Euler``, ``Quaternion``, ``RotationMatrix``,
``Vector`` (reference artelib/{homogeneousmatrix,euler,quaternion,
rotationmatrix,vector}.py) — and scripts compose them with ``*`` / ``inv()``
/ ``Q()`` / ``R()`` / ``euler()``.  This module provides the same class
surface as thin numpy wrappers so such scripts port line-for-line, while
all bulk work stays in the stacked-tensor core.

Conventions match the reference exactly: quaternions are wxyz
(artelib/quaternion.py), Euler is XYZ mobile-axes R = Rx@Ry@Rz with both
branches returned by ``euler()`` (artelib/tools.py:226-275), ``t2v(n=2)``
yields SE(2) [tx, ty, theta] (artelib/homogeneousmatrix.py:95-107).

Interop: every class accepts / returns plain numpy via ``toarray()``;
``stack(list_of_HM)`` / ``unstack(array)`` bridge to the (N, 4, 4) arrays
the pipeline uses.  ``compute_homogeneous_transforms`` takes a pandas
DataFrame or the port's ``{column: array}`` tables (``io.formats.read_csv``)
alike, and imports no pandas.
"""

from __future__ import annotations

import numpy as np

from lidar_slam_arvc_tpu_torch.geom.hostmath import quat_to_rot_np, rot_to_quat_np


def _euler_to_rot_np(abg: np.ndarray) -> np.ndarray:
    """Euler [a, b, g] -> R = Rx@Ry@Rz, float64 (reference tools.py:226-238)."""
    a, b, g = np.asarray(abg, dtype=np.float64)
    ca, sa, cb, sb, cg, sg = np.cos(a), np.sin(a), np.cos(b), np.sin(b), np.cos(g), np.sin(g)
    return np.array([
        [cb * cg, -cb * sg, sb],
        [ca * sg + sa * sb * cg, ca * cg - sa * sb * sg, -sa * cb],
        [sa * sg - ca * sb * cg, sa * cg + ca * sb * sg, ca * cb],
    ])


def _wrap(theta):
    # atan2(sin, cos) form — the reference's normalize_angle
    # (artelib/tools.py:29-37); maps exactly pi to +pi, unlike the modulo
    # form (golden-tested against the reference in the JAX package)
    return np.arctan2(np.sin(theta), np.cos(theta))


def _rot_to_euler_both_np(R: np.ndarray):
    """Both XYZ-mobile branches incl. gimbal lock (reference tools.py:241-275)."""
    R = np.asarray(R, dtype=np.float64)
    r02 = float(np.clip(R[0, 2], -1.0, 1.0))
    if abs(abs(R[0, 2]) - 1.0) <= 1e-4:  # beta = +-pi/2 degenerate
        beta1 = np.arcsin(r02)
        if beta1 > 0:
            b1, b2 = np.pi / 2, np.pi / 2
            g1 = np.arctan2(R[1, 0], R[1, 1])
        else:
            b1, b2 = -np.pi / 2, -np.pi / 2
            g1 = np.arctan2(-R[1, 0], R[1, 1])
        e1 = np.array([0.0, b1, g1])
        e2 = np.array([np.pi, b2, g1 - np.pi])
        return _wrap(e1), _wrap(e2)
    beta1 = np.arcsin(r02)
    beta2 = np.pi - beta1
    out = []
    for beta in (beta1, beta2):
        s = np.sign(np.cos(beta)) or 1.0
        alpha = np.arctan2(-s * R[1, 2], s * R[2, 2])
        gamma = np.arctan2(-s * R[0, 1], s * R[0, 0])
        out.append(_wrap(np.array([alpha, beta, gamma])))
    return out[0], out[1]


class Vector:
    """reference artelib/vector.py — position/direction wrapper."""

    def __init__(self, array):
        self.array = np.asarray(array, dtype=np.float64)

    def toarray(self):
        return self.array

    def pos(self):
        return np.array(self.array)

    def T(self):
        return Vector(self.array.T)

    def homogeneous(self):
        return HomogeneousMatrix(self.array, np.eye(3))

    def cross(self, other):
        return Vector(np.cross(self.array, other.array))

    def __add__(self, other):
        return Vector(self.array + other.array)

    def __sub__(self, other):
        return Vector(self.array - other.array)

    def __mul__(self, other):
        return float(np.dot(self.array, other.array))  # scalar product

    def __str__(self):
        return str(self.array)


class Euler:
    """reference artelib/euler.py — XYZ mobile-axes angles [alpha, beta, gamma]."""

    def __init__(self, abg):
        self.abg = np.asarray(abg.abg if isinstance(abg, Euler) else abg,
                              dtype=np.float64)

    def R(self):
        return RotationMatrix(_euler_to_rot_np(self.abg))

    def Q(self):
        return Quaternion(rot_to_quat_np(_euler_to_rot_np(self.abg)))

    def __str__(self):
        return str(self.abg)


class Quaternion:
    """reference artelib/quaternion.py — wxyz quaternion with Hamilton product."""

    def __init__(self, array):
        self.array = np.asarray(
            array.array if isinstance(array, Quaternion) else array,
            dtype=np.float64)

    def toarray(self):
        return self.array

    def R(self):
        return RotationMatrix(quat_to_rot_np(self.array))

    def Euler(self):
        e1, e2 = _rot_to_euler_both_np(quat_to_rot_np(self.array))
        return Euler(e1), Euler(e2)

    def Q(self):
        return self

    def qconj(self):
        return Quaternion(np.concatenate([self.array[:1], -self.array[1:4]]))

    def dot(self, Q):
        return float(np.dot(self.array, Q.toarray()))

    def __getitem__(self, item):
        return self.array[item]

    def __add__(self, Q):
        return Quaternion(self.array + Q.toarray())

    def __sub__(self, Q):
        return Quaternion(self.array - Q.toarray())

    def __mul__(self, other):
        if isinstance(other, Quaternion):
            q1, q2 = self.array, other.array
            w = q1[0] * q2[0] - np.dot(q1[1:4], q2[1:4])
            v = q1[0] * q2[1:4] + q2[0] * q1[1:4] + np.cross(q1[1:4], q2[1:4])
            return Quaternion(np.concatenate([[w], v]))
        if isinstance(other, (int, float)):
            return Quaternion(other * self.array)
        raise TypeError("Quaternion product: unsupported operand")

    def __truediv__(self, s):
        return Quaternion(self.array / s)

    def homogeneous(self):
        return HomogeneousMatrix(np.zeros(3), self.R())

    def __str__(self):
        return str(self.array)


class RotationMatrix:
    """reference artelib/rotationmatrix.py — SO(3) (or SO(2)) wrapper."""

    def __init__(self, orientation):
        if isinstance(orientation, RotationMatrix):
            self.array = orientation.toarray()
        elif isinstance(orientation, int):
            self.array = np.eye(orientation)
        elif isinstance(orientation, Euler):
            self.array = _euler_to_rot_np(orientation.abg)
        elif isinstance(orientation, Quaternion):
            self.array = quat_to_rot_np(orientation.array)
        else:
            self.array = np.asarray(orientation, dtype=np.float64)

    def toarray(self):
        return self.array

    def inv(self):
        return RotationMatrix(self.array.T)

    def T(self):
        return RotationMatrix(self.array.T)

    def det(self):
        return float(np.linalg.det(self.array))

    def R(self):
        return self

    def Q(self):
        return Quaternion(rot_to_quat_np(self.array))

    def euler(self):
        e1, e2 = _rot_to_euler_both_np(self.array)
        return Euler(e1), Euler(e2)

    def homogeneous(self):
        return HomogeneousMatrix(np.zeros(3), self)

    def __mul__(self, other):
        if isinstance(other, RotationMatrix):
            return RotationMatrix(self.array @ other.array)
        if isinstance(other, Vector):
            return Vector(self.array @ other.array)
        raise TypeError("RotationMatrix product: unsupported operand")

    def __getitem__(self, item):
        return self.array[item[0], item[1]]

    def __str__(self):
        return str(self.array)


def R2(theta):
    c, s = np.cos(theta), np.sin(theta)
    return RotationMatrix(np.array([[c, -s], [s, c]]))


def Rx(theta):
    c, s = np.cos(theta), np.sin(theta)
    return RotationMatrix(np.array([[1, 0, 0], [0, c, -s], [0, s, c]]))


def Ry(theta):
    c, s = np.cos(theta), np.sin(theta)
    return RotationMatrix(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]))


def Rz(theta):
    c, s = np.cos(theta), np.sin(theta)
    return RotationMatrix(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]))


class HomogeneousMatrix:
    """reference artelib/homogeneousmatrix.py:16-144 — SE(3) wrapper."""

    def __init__(self, *args):
        if len(args) == 0:
            self.array = np.eye(4)
        elif len(args) == 1:
            a = args[0]
            self.array = np.asarray(
                a.toarray() if isinstance(a, HomogeneousMatrix) else a,
                dtype=np.float64)
        else:
            position, orientation = args
            if isinstance(position, Vector):
                position = position.array
            position = np.asarray(position, dtype=np.float64)
            if isinstance(orientation, list):
                orientation = Euler(orientation)
            if isinstance(orientation, (Euler, Quaternion)):
                R = orientation.R().array
            elif isinstance(orientation, RotationMatrix):
                R = orientation.array
            else:
                R = np.asarray(orientation, dtype=np.float64)
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = position
            self.array = T

    def toarray(self):
        return self.array

    def print_nice(self, precision=3):
        print(np.array_str(self.array, precision=precision,
                           suppress_small=True))

    def inv(self):
        # closed-form rigid inverse (the wrapped transforms are SE(3))
        R = self.array[:3, :3]
        t = self.array[:3, 3]
        out = np.eye(4)
        out[:3, :3] = R.T
        out[:3, 3] = -R.T @ t
        return HomogeneousMatrix(out)

    def Q(self):
        return Quaternion(rot_to_quat_np(self.array[:3, :3]))

    def R(self):
        return RotationMatrix(self.array[:3, :3])

    def euler(self):
        return self.R().euler()

    def pos(self):
        return self.array[:3, 3]

    def t2v(self, n=2):
        if n == 2:
            return np.array([self.array[0, 3], self.array[1, 3],
                             np.arctan2(self.array[1, 0], self.array[0, 0])])
        abg = self.euler()[0].abg
        return np.concatenate([self.array[:3, 3], abg])

    def __mul__(self, other):
        if isinstance(other, HomogeneousMatrix):
            return HomogeneousMatrix(self.array @ other.array)
        if isinstance(other, Vector):
            return Vector(self.array @ other.array)
        raise TypeError("HomogeneousMatrix product: unsupported operand")

    def __add__(self, other):
        return HomogeneousMatrix(self.array + other.array)

    def __sub__(self, other):
        return HomogeneousMatrix(self.array - other.array)

    def __getitem__(self, item):
        return self.array[item[0], item[1]]

    def __str__(self):
        return str(self.array)


class SerialLink:
    """One Denavit-Hartenberg link (reference artelib/seriallink.py:49-84):
    revolute ('R', q adds to theta) or prismatic ('P', q adds to d)."""

    def __init__(self, th, d, a, alpha, link_type="R"):
        self.th, self.d, self.a, self.alpha = th, d, a, alpha
        self.link_type = link_type

    def dh(self, q):
        theta = self.th + (q if self.link_type == "R" else 0.0)
        d = self.d + (q if self.link_type == "P" else 0.0)
        ct, st = np.cos(theta), np.sin(theta)
        ca, sa = np.cos(self.alpha), np.sin(self.alpha)
        return HomogeneousMatrix(np.array([
            [ct, -ca * st, sa * st, self.a * ct],
            [st, ca * ct, -sa * ct, self.a * st],
            [0.0, sa, ca, d],
            [0.0, 0.0, 0.0, 1.0],
        ]))


class SerialRobot:
    """DH serial-arm forward kinematics (reference artelib/seriallink.py:17-46;
    unused by the SLAM pipeline, kept for artelib API completeness)."""

    def __init__(self, n, T0, name="robot"):
        self.name = name
        self.n = n
        self.T0 = HomogeneousMatrix(T0)
        self.transformations = []

    def append(self, th, d, a, alpha, link_type="R"):
        self.transformations.append(SerialLink(th, d, a, alpha, link_type))

    def directkinematics(self, q):
        T = self.T0
        for i, link in enumerate(self.transformations):
            T = T * link.dh(q[i])
        return T

    def dh(self, q, i):
        return self.transformations[i].dh(q[i])

    def get_link_type(self, i):
        return self.transformations[i].link_type


# --------------------------------------------------------------------------
# trajectory-algebra free functions (reference homogeneousmatrix.py:147-212)
# and bridges to the framework's stacked-tensor form
# --------------------------------------------------------------------------

def _columns(table, names) -> np.ndarray:
    """(N, len(names)) float64 from a table indexed one column at a time:
    a pandas DataFrame or a ``{column: array}`` dict."""
    return np.stack([np.asarray(table[c], dtype=np.float64) for c in names],
                    axis=-1)


def compute_homogeneous_transforms(df_data):
    """Table with x..z, qw..qz (wxyz!) columns -> list of HM
    (reference homogeneousmatrix.py:147-167).  ``df_data``: a pandas
    DataFrame or a ``{column: array}`` dict (``io.formats.read_csv``)."""
    xyz = _columns(df_data, ("x", "y", "z"))
    q = _columns(df_data, ("qw", "qx", "qy", "qz"))
    return [HomogeneousMatrix(xyz[i], Quaternion(q[i]))
            for i in range(len(xyz))]


def compute_relative_transformations(global_transforms):
    """(reference homogeneousmatrix.py:170-181)."""
    return [global_transforms[i].inv() * global_transforms[i + 1]
            for i in range(len(global_transforms) - 1)]


def compute_global_transformations(transforms_relative, T0, Trobot_gps=None):
    """Left-fold of relative transforms then per-pose GPS-lever correction
    (reference homogeneousmatrix.py:184-205)."""
    T = HomogeneousMatrix() if T0 is None else T0
    out = [T]
    for Tij in transforms_relative:
        T = T * Tij
        out.append(T)
    if Trobot_gps is not None:
        out = [Ti * Trobot_gps for Ti in out]
    return out


def multiply_by_transform(transforms, Trel):
    """(reference homogeneousmatrix.py:208-212)."""
    return [Ti * Trel for Ti in transforms]


def stack(transforms) -> np.ndarray:
    """list of HomogeneousMatrix -> (N, 4, 4) float array (framework form)."""
    return np.stack([t.toarray() for t in transforms])


def unstack(T: np.ndarray):
    """(N, 4, 4) array -> list of HomogeneousMatrix (reference form)."""
    return [HomogeneousMatrix(T[i]) for i in range(len(T))]
