"""The check's control on a card: the plain reference computed one precision
below the configuration's float32 (stage 1 in bfloat16, stage 2 with TF32
matmuls), put in the program's place, reads ``correct`` false.  The
benchmark's own runs never run it; ``run.py --control 1`` reads it at the
cells' full size.  Here the sequences are shorter (every width kept), so
that a test run holds them."""

import pytest

from slam_bench import run
from slam_bench.tests import tiny

SHORT = {"kitti00.stage1": {"config": {"motion": {"keyframes": 41}}},
         "nclt.stage2": {"config": {"motion": {"keyframes": 300}},
                         "traffic": {"warmup_keyframes": 20}}}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SHORT))
def test_control_is_not_correct(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = run.run(workload, 2 ** 31 + 99, 1.0, trace_on=False, control=True,
                  overrides=SHORT[workload], manifest=tiny.MANIFEST)
    assert out["correct"] is False, out["checks"]
