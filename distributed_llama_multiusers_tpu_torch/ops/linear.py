"""Matmul dispatch: ``matmul(x, w)`` for dense tensors or PackedQ40 weights.

Dense weights [.., d_in, d_out] take ``x @ w``; packed weights take the Q40
dequant-in-matmul kernels (ops/cuda_q40.py), whose wrappers launch the CUDA
kernel for a CUDA tensor and run the plain version for a CPU tensor. ``x``
may be a ``Q80Acts`` bundle from ``shared_q80_acts``: the packed path
consumes its prebuilt operands, the dense path its original activation.
"""

from __future__ import annotations

import torch

from ..quants.packed import PackedQ40
from .cuda_q40 import Q80Acts, make_q80_acts, q40_matmul


def shared_q80_acts(x: torch.Tensor):
    """The shared operand bundle for ``x``, or x itself when d_in does not
    cover whole quant blocks."""
    if x.shape[-1] % 32 != 0:
        return x
    return make_q80_acts(x)


def _raw_x(x):
    return x.x if isinstance(x, Q80Acts) else x


def matmul(x, w) -> torch.Tensor:
    """y = x @ w for dense [d_in, d_out] tensors or 2D PackedQ40 weights."""
    if isinstance(w, PackedQ40):
        if isinstance(x, Q80Acts) and x.d_in != w.d_in:
            x = x.x
        return q40_matmul(x, w)
    xr = _raw_x(x)
    return torch.matmul(xr, w.to(xr.dtype))
