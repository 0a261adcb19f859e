"""Fused low-rank linear ``y = (x @ B.T) @ A.T + bias`` — kernel 1.

Port of asvd4llm_tpu/ops/pallas_lowrank.py::_fused_2d (public wrapper
``fused_lowrank_apply``). The kernel is hand-written CUDA for Hopper in
``csrc/fused_lowrank.cu`` (its header says what bounds it and how it is
laid out); ``fused_lowrank_reference`` is its plain PyTorch version with
the same casts:

  t = x · Bᵀ in f32; y = (t rounded to A's dtype) · Aᵀ in f32
      + bias (in x's dtype) ; one rounding to x's dtype.

Dispatch keeps the JAX wrapper's rule: above ``MAX_FUSED_TOKENS`` tokens
the op runs as two plain matmuls (the JAX package hands those shapes to
XLA). At or below it, a CUDA tensor launches the kernel or raises, and a
CPU tensor takes the plain version. ``_form`` names, from the shape, the
form of the kernel a call runs (the header of the CUDA source describes
each); the launcher is told which.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from asvd4llm_tpu_torch.ops import _build

MAX_FUSED_TOKENS = 1024  # pallas_lowrank.py:530
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SKINNY_MAX_M = 16          # M at or below it takes the decode forms
_FORM_CODES = {"wgmma_tiled": 1}   # every other form is the launcher's code 0


def _form(M: int, K: int, R: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The kernel form a call of kernel 1 runs: "wgmma_tiled" (bf16, M > 16,
    K and R multiples of 8, 16-byte aligned operands), "mma_skinny" (bf16,
    M <= 16, aligned), "wmma_tiled" (bf16, M > 16, K aligned, R not a
    multiple of 8) or "cuda_cores" (f32, or bf16 rows not 16-byte
    aligned)."""
    if dtype != torch.bfloat16 or K % 8 or not aligned:
        return "cuda_cores"
    if M <= _SKINNY_MAX_M:
        return "mma_skinny"
    return "wgmma_tiled" if R % 8 == 0 else "wmma_tiled"


def fused_lowrank_reference(x2: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain version of the kernel on x2 [M, K] -> [M, N]."""
    t = torch.matmul(x2.float(), b.float().t())
    y = torch.matmul(t.to(a.dtype).float(), a.float().t())
    if bias is not None:
        y = y + bias.to(x2.dtype).float()
    return y.to(x2.dtype)


def _launch(x2: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            bias: Optional[torch.Tensor], form: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel in the form `_form` names; `form` (measurements
    only) names another, which the launcher refuses where the shape does
    not allow it ("wmma_tiled" on a "wgmma_tiled" shape runs the WMMA tiles
    with split-K atomics)."""
    M, K = x2.shape
    N, R = a.shape
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_lowrank: dtype {x2.dtype} not supported "
                        f"(float32, bfloat16)")
    tensors = {"x": x2, "a": a, "b": b}
    if bias is not None:
        tensors["bias"] = bias
    for nm, t in tensors.items():
        if t.device != x2.device:
            raise ValueError(f"fused_lowrank: {nm} on {t.device}, x on {x2.device}")
        if t.dtype != x2.dtype:
            raise TypeError(f"fused_lowrank: {nm} is {t.dtype}, x is {x2.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_lowrank: {nm} is not contiguous")
    if tuple(b.shape) != (R, K) or (bias is not None and tuple(bias.shape) != (N,)):
        raise ValueError(f"fused_lowrank: shapes x {tuple(x2.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    form = form or _form(M, K, R, x2.dtype, all(t.data_ptr() % 16 == 0 for t in (x2, a, b)))
    lib = _build.library("fused_lowrank")
    fn = lib.fused_lowrank_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    y = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if form == "wgmma_tiled":   # t [M, R], rounded to bf16 by stage 1
        scratch = torch.empty((M * R,), dtype=torch.bfloat16, device=x2.device)
    else:   # 64-bit split-K accumulators of t [M, R] and y [M, N], two f32
            # slots each
        scratch = torch.empty((2 * M * (R + N),), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = fn(x2.data_ptr(), b.data_ptr(), a.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(),
                 scratch.data_ptr(), M, K, R, N,
                 _DTYPE_CODES[x2.dtype], _FORM_CODES.get(form, 0), stream)
    _build.check(lib, "fused_lowrank", err)
    fused_lowrank_apply.launches += 1
    fused_lowrank_apply.last_form = form
    by_form = fused_lowrank_apply.form_launches
    by_form[form] = by_form.get(form, 0) + 1
    return y


def fused_lowrank_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, *,
                        max_tokens: int = MAX_FUSED_TOKENS) -> torch.Tensor:
    """x [..., K] -> [..., N]; a [N, R], b [R, K], bias [N] or None."""
    K = x.shape[-1]
    N = a.shape[0]
    lead = x.shape[:-1]
    M = 1
    for d in lead:
        M *= d
    if M > max_tokens:
        from asvd4llm_tpu_torch.ops.lowrank import lowrank_apply
        return lowrank_apply(x, a, b, bias, use_pallas=False)
    x2 = x.reshape(M, K)
    if x.device.type == "cuda":
        y = _launch(x2, a, b, bias)
    elif x.device.type == "cpu":
        y = fused_lowrank_reference(x2, a, b, bias)
    else:
        raise ValueError(f"fused_lowrank: no kernel for device {x.device}")
    return y.reshape(*lead, N)


# launches of the CUDA kernel in this process (the plain version and the
# large-M matmul path do not count), the form of the last launch, and the
# launches by form
fused_lowrank_apply.launches = 0
fused_lowrank_apply.last_form = None
fused_lowrank_apply.form_launches = {}
