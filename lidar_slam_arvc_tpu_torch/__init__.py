"""lidar_slam_arvc_tpu_torch — the LiDAR SLAM pipeline (stages 1 and 2) on PyTorch + CUDA.

The port of ``lidar_slam_arvc_tpu`` (JAX on a TPU) to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (``sm_90a``).  The layout
mirrors the JAX package module for module, so each counterpart is easy to
find:

geom          SO(3)/SE(3) algebra on tensors (quaternions, Euler, exp/log,
              trajectories); float64 numpy host mirrors
io            PCD files (native parser), EUROC CSV/YAML layer (numpy + csv, no
              pandas/yaml), UTM, ROS1 bag ingest
cloud         Cloud container, crop, compaction, voxel downsample, normals
              (K2, or raw moments with impl="xla")
ops           3x3 eigensolver; the CUDA kernels (NN sweeps, ball moments)
registration  batched point-to-plane / point-to-point ICP
graph         pose graph: factors, dense LM and PCG solvers, marginals
keyframes     keyframe store: preprocessed scans, batched registration
loop          triangle-gated loop closing
pipeline      stage-1 scan matcher, stage-2 graph SLAM, preprocessing, CLI
parallel      process-group meshes: sharded ICP, distributed and Schur solves,
              multihost, the multi-rank dry run
viz           trajectory/uncertainty/GPS PNGs, global map, PLY meshes, diagnostics
utils         IcpConfig (from_yaml), ATE/RPE metrics, synthetic EUROC datasets,
              profiling
compat        artelib-compatible value classes (HomogeneousMatrix, ...) in numpy
              float64, for line-for-line porting of reference scripts

The package imports torch, numpy and the standard library — matplotlib
and scipy only when a figure or a mesh is made, never jax, pandas or
PyYAML — so it runs on a machine that has none of them.  Kernels build
with nvcc at first use (``ops/_cuda.py``), the PCD parser with g++
(``io/native.py``); a wrapper given a CPU tensor runs its kernel's plain
PyTorch version instead.  Every function that takes a ``device`` defaults
to ``"cuda"``: with no card that raises; pass ``device="cpu"`` for the
plain versions.
"""

__version__ = "0.1.0"
