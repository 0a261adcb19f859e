"""Low-rank and dense linear application.

The compressed forward replaces one GEMM ``y = x @ W.T + b`` with two
(ref svd_linear.py:105-109): ``y = (x @ B.T) @ A.T + b``.

Two execution paths, as in the JAX package:
- plain tensor ops (this module): two matmuls, each rounded once to x's
  dtype, the bias added inside the second one;
- the fused kernel (ops/fused_lowrank.py) when ``use_pallas`` is set: a
  hand-written CUDA kernel on a CUDA tensor, its plain version on the CPU.
  (The flag keeps the JAX package's name so that the two packages' calls
  read alike.)
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dense_apply(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = x @ w.T + b`` accumulated in f32, one rounding to x's dtype."""
    return F.linear(x, w, None if bias is None else bias.to(x.dtype))


def lowrank_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  use_pallas: bool = False) -> torch.Tensor:
    """``y = (x @ B.T) @ A.T + b`` (ref svd_linear.py:105-109).

    a: [out, rank], b: [rank, in], x: [..., in] -> [..., out]
    """
    if use_pallas:
        from asvd4llm_tpu_torch.ops.fused_lowrank import fused_lowrank_apply
        return fused_lowrank_apply(x, a, b, bias)
    t = F.linear(x, b)
    return F.linear(t, a, None if bias is None else bias.to(x.dtype))
