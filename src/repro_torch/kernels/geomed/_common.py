"""What the GMoM kernels' wrappers (``round.py``, ``geomed.py``) share:
the launch geometry of the column-parallel kernels and the input cast."""

from __future__ import annotations

import torch

# threads per block of every column-parallel kernel, and the most blocks a
# grid takes (a block then walks its columns with a grid stride)
THREADS = 256
MAX_BLOCKS = 1024


def num_blocks(d: int) -> int:
    """Blocks of a column-parallel launch over d columns."""
    return max(1, min(-(-d // THREADS), MAX_BLOCKS))


def as_f32(x):
    """Contiguous float32, as the kernels take it."""
    return x.to(torch.float32).contiguous()


def stream(t):
    """The current CUDA stream of ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
