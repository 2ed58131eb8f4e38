"""B1 generic's launch shape (ceres_tpu_torch/eval_kernel.py), held here on
the CPU: the threads per block and the blocks of a launch over n residual
blocks, which size the cost partials the kernel writes, and the
constants of csrc/eval_generic.cuh that the kernel reads them from. The
launch itself is held on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py phase 2)."""

import re
from pathlib import Path

import pytest

from ceres_tpu_torch import eval_kernel

HEADER = Path(eval_kernel.__file__).parent / "csrc" / "eval_generic.cuh"


# (n, threads per block, blocks): empty and tiny groups, sphere2500's 3D
# pose-graph edges, the FoE 5x5 clique group at 213 x 177, the edge of a
# wave of 512-thread blocks on 132 SMs, the FoE 3x3 clique group at 512 x
# 512 and Snavely through the generator at BAL-1778 (past the grid cap)
@pytest.mark.parametrize("n,block,blocks", [
    (0, 128, 1), (1, 128, 1), (4949, 128, 39), (36_157, 128, 283), (67_583, 128, 528),
    (67_584, 512, 132), (260_100, 512, 509), (5_000_000, 512, 2048),
])
def test_generic_launch_shape(n, block, blocks):
    """512 threads a block where n fills a block per SM of an H100, else
    128; ceil(n / block) blocks, at least one and at most
    GENERIC_MAX_BLOCKS, each striding over the lanes beyond."""
    assert eval_kernel.generic_block(n) == block
    assert eval_kernel.generic_blocks(n) == blocks
    assert blocks * block >= n or blocks == eval_kernel.GENERIC_MAX_BLOCKS


def test_launch_constants_match_the_kernel():
    """The wrapper sizes the partials with the kernel's own constants: the
    two block sizes, the lane count where the wide one starts and the grid
    cap are those of csrc/eval_generic.cuh."""
    src = HEADER.read_text()
    narrow, wide = map(int, re.search(
        r"constexpr int kNarrowBlock = (\d+), kWideBlock = (\d+);", src).groups())
    sms = int(re.search(r"constexpr int kWideLanes = (\d+) \* kWideBlock;", src).group(1))
    cap = int(re.search(r"constexpr int kMaxBlocks = (\d+);", src).group(1))
    assert cap == eval_kernel.GENERIC_MAX_BLOCKS
    assert eval_kernel.generic_block(sms * wide - 1) == narrow
    assert eval_kernel.generic_block(sms * wide) == wide
