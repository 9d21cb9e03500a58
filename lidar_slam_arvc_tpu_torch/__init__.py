"""lidar_slam_arvc_tpu_torch — the LiDAR SLAM pipeline (stages 1 and 2) on PyTorch + CUDA.

The port of ``lidar_slam_arvc_tpu`` (JAX on a TPU) to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (``sm_90a``).  The layout
mirrors the JAX package module for module, so each counterpart is easy to
find:

geom          SE(3)/SO(3) algebra on tensors; float64 numpy host mirrors
io            PCD files, EUROC CSV/YAML layer (numpy + csv, no pandas/yaml), UTM
cloud         Cloud container, crop, compaction, voxel downsample, normals
ops           3x3 eigensolver; the two CUDA kernels (NN sweep, ball moments)
registration  batched point-to-plane / point-to-point ICP
graph         pose graph: factors, dense LM and PCG solvers, marginals
keyframes     keyframe store: preprocessed scans, batched registration
loop          triangle-gated loop closing
pipeline      stage-1 scan matcher, stage-2 graph SLAM, preprocessing, CLI
utils         IcpConfig, ATE/RPE metrics, synthetic EUROC datasets

The package imports torch, numpy and the standard library only — never
jax, pandas or PyYAML — so it runs on a machine that has none of them.
Kernels build with nvcc at first use (``ops/_cuda.py``); a wrapper given a
CPU tensor runs its kernel's plain PyTorch version instead.
"""

__version__ = "0.1.0"
