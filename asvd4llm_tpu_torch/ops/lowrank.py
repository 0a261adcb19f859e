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

``align_ranks`` zero-pads every low-rank leaf's rank to a multiple of 8,
which the kernels' tensor-core forms need for 16-byte rows (TMA and
wgmma), and every int8 leaf's rank to a multiple of 16 (16-byte rows of
int8 codes). The padding is exact: the zero rows of B give latent columns
that are exactly 0, and the zero columns of A add nothing; an int8 leaf's
new B8 rows have scale 0 and zero point 0, so its latent columns are
exactly 0 too, and its new A8 code columns are 0, which leaves the row
sums of t as they were. Packed int4 leaves need nothing: quantization pads
their ranks to multiples of 512. The decode, evaluation and serving entry
points apply it once when they run the kernels, after the search, so the
latent caches they allocate come out padded too, and the rank manifest
keeps the true ranks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from asvd4llm_tpu_torch.models.registry import (
    is_lowrank, is_q8_lowrank, iter_linears, set_linear,
)

RANK_MULTIPLE = 8      # bf16 elements in 16 bytes
Q8_RANK_MULTIPLE = 16  # int8 codes in 16 bytes


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


def _rank(leaf: dict) -> int:
    return leaf["Bsc"].shape[0] if is_q8_lowrank(leaf) else leaf["A"].shape[1]


def pad_rank(leaf: dict, multiple: int = RANK_MULTIPLE) -> dict:
    """A low-rank leaf with its rank zero-padded up to a multiple of
    `multiple` (A [N, R] gains zero columns, B [R, K] zero rows). An int8
    leaf (A8/B8 codes, per-row scales) is padded up to a multiple of
    Q8_RANK_MULTIPLE at least: A8 gains code columns 0, B8 code rows 0
    with Bsc = Bzp = 0."""
    R = _rank(leaf)
    if is_q8_lowrank(leaf):
        pad = -R % max(multiple, Q8_RANK_MULTIPLE)
        if not pad:
            return leaf
        rows = lambda v: F.pad(v[:R], (0, 0, 0, pad))  # noqa: E731
        return dict(leaf, A8=F.pad(leaf["A8"][:, :R], (0, pad)), B8=rows(leaf["B8"]),
                    Bsc=rows(leaf["Bsc"]), Bzp=rows(leaf["Bzp"]))
    pad = -R % multiple
    if not pad:
        return leaf
    return dict(leaf, A=F.pad(leaf["A"], (0, pad)), B=F.pad(leaf["B"], (0, 0, 0, pad)))


def align_ranks(params: dict, spec, multiple: int = RANK_MULTIPLE) -> dict:
    """params with every low-rank and int8 low-rank leaf through
    `pad_rank` (a new dict; the given one is not changed)."""
    for name, leaf in list(iter_linears(params, spec, include_extras=True)):
        if is_lowrank(leaf) or is_q8_lowrank(leaf):
            padded = pad_rank(leaf, multiple)
            if padded is not leaf:
                params = set_linear(params, spec, name, padded)
    return params
