"""SE(3)/SO(3) algebra on tensors (se3, rotations) and float64 numpy host mirrors (hostmath)."""
