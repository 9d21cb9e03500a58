"""Framework-global ICP/crop parameters.

Counterpart of ``lidar_slam_arvc_tpu/utils/config.py``: the same fields
and defaults, so ``IcpConfig(**dataclasses.asdict(jax_cfg))`` converts the
reference's settings, and ``from_yaml`` reads the reference's nested
``icp_parameters.yaml`` (through the port's own YAML subset,
``io.formats.load_yaml``).  ``checkpoint_batches > 0`` turns on stage 1's
mid-stage checkpoint, as in the reference.  ``mesh_devices`` and
``shard_scans`` ask for a mesh of ranks (``parallel/mesh.py``): the
stages then run over the ranks of the process group.
"""

from __future__ import annotations

import dataclasses

from lidar_slam_arvc_tpu_torch.io.formats import load_yaml


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """Defaults = reference config/icp_parameters.yaml."""
    max_radius: float = 35.0
    min_radius: float = 0.5
    min_height: float = -1.0
    max_height: float = 50.0
    # None keeps full resolution
    voxel_size: float | None = None
    normal_radius: float = 0.3
    normal_radius_ground: float = 0.5
    distance_threshold: float = 10.0
    fpfh_radius: float = 1.0
    # a pair whose ICP inlier fraction falls below this keeps its odometry seed
    min_fitness: float = 0.1
    checkpoint_batches: int = 0
    raw_capacity: int = 65536       # padded size of a loaded scan
    capacity: int = 16384           # padded size after crop+voxel downsample
    max_iterations: int = 30
    # scan pairs per ICP group: a group iterates until every member's
    # early exit fires
    batch_size: int = 4
    # persistent source subsampling inside ICP (ICPParams.source_stride)
    source_stride: int = 1
    mesh_devices: int = 1
    shard_scans: bool = False

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "IcpConfig":
        """The defaults with the six fields an ``icp_parameters.yaml`` sets
        (``filter_by_radius``, ``filter_by_height``, ``down_sample``,
        ``icp``), then ``overrides``."""
        with open(path) as f:
            y = load_yaml(f.read())
        kw = dict(
            max_radius=y["filter_by_radius"]["max_radius"],
            min_radius=y["filter_by_radius"]["min_radius"],
            max_height=y["filter_by_height"]["max_height"],
            min_height=y["filter_by_height"]["min_height"],
            voxel_size=y["down_sample"]["voxel_size"],
            distance_threshold=y["icp"]["distance_threshold"],
        )
        kw.update(overrides)
        return cls(**kw)
