"""SE(3) pose-graph optimisation: factors, the dense LM and PCG solvers,
marginals, and the incremental ``PoseGraph`` (counterpart of
``lidar_slam_arvc_tpu.graph``)."""

from lidar_slam_arvc_tpu_torch.graph.builder import PoseGraph
from lidar_slam_arvc_tpu_torch.graph.factors import (
    DEFAULT_SIGMAS, FactorData, NoiseSigmas, make_factor_data,
)
from lidar_slam_arvc_tpu_torch.graph.solver import (
    graph_cost, marginal_covariances, solve_graph,
)

__all__ = ["NoiseSigmas", "DEFAULT_SIGMAS", "FactorData", "make_factor_data",
           "solve_graph", "graph_cost", "marginal_covariances", "PoseGraph"]
