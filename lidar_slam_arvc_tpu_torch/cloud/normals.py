"""Normal estimation from ball-neighbourhood covariance.

Counterpart of ``lidar_slam_arvc_tpu/cloud/normals.py``: per point, the
normal is the smallest-eigenvalue eigenvector of the covariance of the
neighbours within ``radius``, from the closed-form 3x3 solve.  The moments
come from the route ``impl`` names, as in the reference:

- ``"auto"`` (the default) and ``"pallas"``: K2
  (``ops.moments.ball_moments``, query-centred moments): the CUDA kernel
  for a CUDA cloud, its plain version for a CPU cloud;
- ``"xla"``: ``ops.nn.radius_accumulate`` (raw-origin moments from f32
  matmuls), on every device.

Any other name raises ``ValueError`` (``"pallas_interpret"`` too: the
reference's CPU-debuggable Pallas mode has no counterpart here).
"""

from __future__ import annotations

import torch

from lidar_slam_arvc_tpu_torch.cloud.cloud import Cloud
from lidar_slam_arvc_tpu_torch.ops.eigh3 import smallest_eigenvector_sym3
from lidar_slam_arvc_tpu_torch.ops.moments import ball_moments
from lidar_slam_arvc_tpu_torch.ops.nn import radius_accumulate

IMPLS = ("auto", "pallas", "xla")


def _cov_from_moments(count, s1, s2):
    """Covariance cov = S2/n - m m^T from ball moments, query-centred (K2)
    or raw-origin (``radius_accumulate``): the algebra is the same, only
    the frame of the mean differs.  For raw moments the subtraction
    cancels catastrophically, which is why their matmuls must stay f32."""
    n = torch.clamp(count, min=1.0)
    m = s1 / n[..., None]                    # mean offset from the query
    xx, xy, xz, yy, yz, zz = s2.unbind(-1)
    mx, my, mz = m.unbind(-1)
    c00 = xx / n - mx * mx
    c01 = xy / n - mx * my
    c02 = xz / n - mx * mz
    c11 = yy / n - my * my
    c12 = yz / n - my * mz
    c22 = zz / n - mz * mz
    return torch.stack([
        torch.stack([c00, c01, c02], dim=-1),
        torch.stack([c01, c11, c12], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)


def estimate_normals(cloud: Cloud, radius: float,
                     orient_to_viewpoint: bool = True,
                     impl: str = "auto") -> Cloud:
    """The cloud with unit ``normals`` for its (..., CAP) points.

    Points with fewer than 3 ball neighbours (self included) get +z.  With
    ``orient_to_viewpoint`` the normals face the sensor origin.  ``impl``
    picks the moments' route (module docstring).
    """
    if impl in ("auto", "pallas"):
        count, s1, s2 = ball_moments(cloud.points, cloud.points, cloud.mask,
                                     float(radius), query_mask=cloud.mask)
    elif impl == "xla":
        # no query mask, as in the reference: masked rows get moments too,
        # and the caller ignores them
        count, s1, s2 = radius_accumulate(cloud.points, cloud.points,
                                          cloud.mask, radius)
    else:
        raise ValueError(f"unknown impl {impl!r} ({'|'.join(IMPLS)})")
    normals = smallest_eigenvector_sym3(_cov_from_moments(count, s1, s2))
    if orient_to_viewpoint:
        # flip so n . (viewpoint - p) >= 0 with viewpoint = sensor origin
        facing = torch.sum(normals * cloud.points, dim=-1, keepdim=True)
        normals = torch.where(facing > 0, -normals, normals)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=normals.dtype,
                      device=normals.device)
    normals = torch.where((count < 3.0)[..., None], ez, normals)
    return Cloud(points=cloud.points, mask=cloud.mask, normals=normals)
