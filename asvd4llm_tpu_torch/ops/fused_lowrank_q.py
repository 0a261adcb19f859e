"""Fused low-rank linears with quantized factors — kernels 3 and 4.

Ports of asvd4llm_tpu/ops/pallas_lowrank.py::_fused_2d_q8 (public wrapper
``fused_lowrank_apply_q8``) and ::_fused_2d_q4 (``fused_lowrank_apply_q4``).
The kernels are hand-written CUDA for Hopper in ``csrc/fused_lowrank_q8.cu``
and ``csrc/fused_lowrank_q4.cu`` (their headers say what bounds them and
how they are laid out). Beside each is its plain PyTorch version with the
same casts:

  q8: dq = scale·(code − zero) in f32; t = x · dq(B)ᵀ in f32, rounded once
      to x's dtype; y = t · dq(A)ᵀ in f32 + bias (in x's dtype), one
      rounding. (The kernel multiplies raw codes and applies scale and zero
      after each sum, which is the same function.)
  q4: dq = code·scale − zero_scale in f32, rounded to x's dtype; then the
      casts of kernel 1's ``fused_lowrank_reference``.

Dispatch keeps the JAX wrappers' rule: above ``max_tokens`` tokens the op
is dequantize + two plain matmuls (what the JAX package runs there and on
the CPU). At or below it, a CUDA tensor launches the kernel or raises, and
a CPU tensor takes the plain version. True dims come from the scales, so
code arrays may arrive padded (as the JAX serving engine pre-pads them).
``_form_q8`` and ``_form_q4`` name, from the shape, the form of kernel 3 or
4 a call runs (the headers of the CUDA sources describe each);
``fused_lowrank_q8_tiled_model`` and ``fused_lowrank_q4_tiled_model`` are
the plain versions of the arithmetic of their "wgmma_tiled" forms.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from asvd4llm_tpu_torch.ops import _build
from asvd4llm_tpu_torch.ops.fused_lowrank import (
    _DTYPE_CODES, _FORM_CODES, _SKINNY_MAX_M, MAX_FUSED_TOKENS, fused_lowrank_reference,
)
from asvd4llm_tpu_torch.ops.lowrank import lowrank_apply
from asvd4llm_tpu_torch.ops.quant import (
    QuantParams, dequantize, dequantize_int4_grouped,
)


def _tokens(x):
    M = 1
    for d in x.shape[:-1]:
        M *= d
    return M


def _check(kind, x2, tensors, dtypes):
    """Device, dtype and contiguity checks shared by both launches."""
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"{kind}: dtype {x2.dtype} not supported (float32, bfloat16)")
    for nm, t in tensors.items():
        if t is None:
            continue
        if t.device != x2.device:
            raise ValueError(f"{kind}: {nm} on {t.device}, x on {x2.device}")
        want = dtypes.get(nm, x2.dtype)
        if t.dtype != want:
            raise TypeError(f"{kind}: {nm} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{kind}: {nm} is not contiguous")


def _launch(name, x2, tensors, ints, N, R, split_k=True):
    """Launch csrc/<name>.cu's entry point on `tensors` (pointers; None is a
    null pointer) and `ints`; returns y [M, N]. `split_k`: the form sums
    over K in a scratch of 64-bit fixed-point accumulators."""
    M = x2.shape[0]
    lib = _build.library(name)
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (len(tensors) + 3)
                   + [ctypes.c_int] * (len(ints) + 1) + [ctypes.c_void_p])
    y = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    # split-K sums of t [M, R] and y [M, N] (+ two row-sum vectors), 64-bit
    # accumulators (two f32 slots each) zeroed by the launcher; t rounded to
    # the io dtype for stage 2
    scratch = torch.empty((2 * M * (R + N + 2) if split_k else 0,), dtype=torch.float32,
                          device=x2.device)
    t = torch.empty((M, R), dtype=x2.dtype, device=x2.device)
    ptrs = [None if a is None else a.data_ptr() for a in (*tensors, y, scratch, t)]
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = fn(*ptrs, *ints, _DTYPE_CODES[x2.dtype], stream)
    _build.check(lib, name, err)
    return y


# ------------------------------------------------------------------ q8 ----

def _form_q8(M: int, K: int, R: int, ldb: int, lda: int, dtype: torch.dtype,
             aligned: bool = True) -> str:
    """The kernel form a call of kernel 3 runs: "wgmma_tiled" (bf16,
    M > 16, K and R multiples of 8, code rows 16-byte aligned: ldb and lda
    multiples of 16), "mma_skinny" (bf16, M <= 16), "wmma_tiled" (bf16,
    M > 16, the other ranks and code rows), or "cuda_cores" (f32, or bf16
    with K or ldb not a multiple of 16, or operands not 16-byte aligned)."""
    if dtype != torch.bfloat16 or K % 16 or ldb % 16 or not aligned:
        return "cuda_cores"
    if M <= _SKINNY_MAX_M:
        return "mma_skinny"
    return "wgmma_tiled" if R % 8 == 0 and lda % 16 == 0 else "wmma_tiled"


def fused_lowrank_q8_tiled_model(x2: torch.Tensor, a8, asc, azp, b8, bsc, bzp,
                                 bias: Optional[torch.Tensor], bk: int = 64) -> torch.Tensor:
    """The arithmetic of the "wgmma_tiled" form in plain PyTorch: products
    of raw codes summed in f32; rowsum(x) in f32, stage by stage of 64
    columns as the kernel streams x; t = T(bsc·acc − (bsc·bzp)·rowsum(x))
    rounded once; rowsum(t) of the rounded t the same way;
    y = T(asc·(t·A8ᵀ) − (asc·azp)·rowsum(t) + bias)."""
    N, R, K = asc.shape[0], bsc.shape[0], x2.shape[1]
    asc, azp, bsc, bzp = (v.reshape(-1).float() for v in (asc, azp, bsc, bzp))

    def stage_sums(v):
        return sum(v[:, k:k + bk].float().sum(dim=1) for k in range(0, v.shape[1], bk))

    acc = torch.matmul(x2.float(), b8[:R, :K].float().t())
    t = (acc * bsc - stage_sums(x2)[:, None] * (bsc * bzp)).to(x2.dtype)
    y = torch.matmul(t.float(), a8[:N, :R].float().t())
    y = y * asc - stage_sums(t)[:, None] * (asc * azp)
    if bias is not None:
        y = y + bias.to(x2.dtype).float()
    return y.to(x2.dtype)


def fused_lowrank_q8_reference(x2: torch.Tensor, a8, asc, azp, b8, bsc, bzp,
                               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain version of the q8 kernel on x2 [M, K] -> [M, N]; N and R are
    the scales' lengths, the codes may be wider."""
    N, R, K = asc.shape[0], bsc.shape[0], x2.shape[1]
    a = dequantize(a8[:N, :R], QuantParams(asc.reshape(N, 1), azp.reshape(N, 1), 255))
    b = dequantize(b8[:R, :K], QuantParams(bsc.reshape(R, 1), bzp.reshape(R, 1), 255))
    t = torch.matmul(x2.float(), b.t())
    y = torch.matmul(t.to(x2.dtype).float(), a.t())
    if bias is not None:
        y = y + bias.to(x2.dtype).float()
    return y.to(x2.dtype)


def _launch_q8(x2, a8, asc, azp, b8, bsc, bzp, bias, form=None):
    """Launch kernel 3 in the form `_form_q8` names; `form` (measurements
    only) names another, which the launcher refuses where the shape does
    not allow it."""
    M, K = x2.shape
    N, R = asc.shape[0], bsc.shape[0]
    f32, i8 = torch.float32, torch.int8
    _check("fused_lowrank_q8",
           x2, {"x": x2, "a8": a8, "asc": asc, "azp": azp, "b8": b8, "bsc": bsc,
                "bzp": bzp, "bias": bias},
           {"a8": i8, "b8": i8, "asc": f32, "azp": f32, "bsc": f32, "bzp": f32})
    if (a8.dim() != 2 or b8.dim() != 2 or a8.shape[0] < N or a8.shape[1] < R
            or b8.shape[0] < R or b8.shape[1] < K
            or any(s.numel() != n for s, n in ((asc, N), (azp, N), (bsc, R), (bzp, R)))
            or (bias is not None and tuple(bias.shape) != (N,))):
        raise ValueError(f"fused_lowrank_q8: shapes x {tuple(x2.shape)}, a8 "
                         f"{tuple(a8.shape)}, b8 {tuple(b8.shape)}, N {N}, R {R}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    ldb, lda = b8.shape[1], a8.shape[1]
    form = form or _form_q8(M, K, R, ldb, lda, x2.dtype,
                            all(t.data_ptr() % 16 == 0 for t in (x2, a8, b8)))
    code = _FORM_CODES.get(form, 0)
    y = _launch("fused_lowrank_q8", x2, (x2, b8, bsc, bzp, a8, asc, azp, bias),
                (M, K, R, N, ldb, lda, code), N, R, split_k=code == 0)
    counter = fused_lowrank_apply_q8
    counter.launches += 1
    counter.last_form = form
    counter.form_launches[form] = counter.form_launches.get(form, 0) + 1
    return y


def fused_lowrank_apply_q8(x: torch.Tensor, a8: torch.Tensor, a_qp: QuantParams,
                           b8: torch.Tensor, b_qp: QuantParams,
                           bias: Optional[torch.Tensor] = None, *,
                           max_tokens: int = MAX_FUSED_TOKENS) -> torch.Tensor:
    """x [..., K] -> [..., N] through int8 factors: a8 [>=N, >=R] and b8
    [>=R, >=K] int8 codes, a_qp / b_qp per-row (scale, zero) [N, 1] / [R, 1]."""
    K = x.shape[-1]
    N, R = a_qp.scale.shape[0], b_qp.scale.shape[0]
    lead = x.shape[:-1]
    M = _tokens(x)
    if M > max_tokens:
        a = dequantize(a8[:N, :R], a_qp, x.dtype)
        b = dequantize(b8[:R, :K], b_qp, x.dtype)
        return lowrank_apply(x, a, b, bias)
    x2 = x.reshape(M, K)
    bias = None if bias is None else bias.to(x.dtype)
    args = (x2, a8, a_qp.scale, a_qp.zero, b8, b_qp.scale, b_qp.zero, bias)
    if x.device.type == "cuda":
        y = _launch_q8(*args)
    elif x.device.type == "cpu":
        y = fused_lowrank_q8_reference(*args)
    else:
        raise ValueError(f"fused_lowrank_q8: no kernel for device {x.device}")
    return y.reshape(*lead, N)


# ------------------------------------------------------------------ q4 ----

def _q4_factors(a4, asc, azs, b4, bsc, bzs, group, K, dtype):
    """Dequantized (A [N, Rp], B [Rp, K]) in `dtype`: computed in f32 and
    rounded once, B cut to x's K columns (its padded columns meet x's zero
    padding in the JAX package)."""
    N, Rp = asc.shape[0], b4.shape[0]
    a = dequantize_int4_grouped(a4[:N], asc, azs, group=group, dtype=dtype)[:, :Rp]
    b = dequantize_int4_grouped(b4, bsc, bzs, group=group, dtype=dtype)[:, :K]
    return a, b


def fused_lowrank_q4_reference(x2: torch.Tensor, a4, asc, azs, b4, bsc, bzs,
                               bias: Optional[torch.Tensor], group: int = 128
                               ) -> torch.Tensor:
    """Plain version of the q4 kernel on x2 [M, K] -> [M, N]."""
    a, b = _q4_factors(a4, asc, azs, b4, bsc, bzs, group, x2.shape[1], x2.dtype)
    return fused_lowrank_reference(x2, a, b, bias)


def _form_q4(M: int, K: int, dtype: torch.dtype, w_aligned: bool = True,
             x_aligned: bool = True) -> str:
    """The kernel form a call of kernel 4 runs: "wgmma_tiled" (bf16,
    M > 16, K a multiple of 8, 16-byte aligned x and codes), "mma_skinny"
    (bf16, M <= 16), "wmma_tiled" (bf16, M > 16, the other x), or
    "cuda_cores" (f32, or codes not 16-byte aligned). Code rows are always
    16-byte multiples: Rp and Kp are multiples of 512."""
    if dtype != torch.bfloat16 or not w_aligned:
        return "cuda_cores"
    if M <= _SKINNY_MAX_M:
        return "mma_skinny"
    return "wgmma_tiled" if K % 8 == 0 and x_aligned else "wmma_tiled"


def fused_lowrank_q4_tiled_model(x2: torch.Tensor, a4, asc, azs, b4, bsc, bzs,
                                 bias: Optional[torch.Tensor], group: int = 128,
                                 bk: int = 64) -> torch.Tensor:
    """The arithmetic of the "wgmma_tiled" form in plain PyTorch: each
    factor dequantized (code·scale − zero_scale in f32, rounded once to x's
    dtype) and consumed in the kernel's half-steps: ring stage kt holds the
    packed bytes [bk·kt, bk·kt + bk) of every row, whose low nibbles are the
    logical columns (kt·bk // 256)·512 + (kt·bk % 256) + [0, bk) and whose
    high nibbles are those + 256; each half is one product of x's columns
    there, summed in f32 in that order. t = T(sum) over all Rp rows of B4;
    y = T(T(t)·dq(A4)ᵀ over Rp + bias)."""
    N, Rp, K = asc.shape[0], b4.shape[0], x2.shape[1]
    a = dequantize_int4_grouped(a4[:N], asc, azs, group=group, dtype=x2.dtype)
    b = dequantize_int4_grouped(b4, bsc, bzs, group=group, dtype=x2.dtype)

    def gemm(xv, w):   # xv [M, cols] (zero past its width), w [rows, 2·bytes]
        xv = torch.nn.functional.pad(xv.float(), (0, w.shape[1] - xv.shape[1]))
        acc = torch.zeros(xv.shape[0], w.shape[0], dtype=torch.float32, device=xv.device)
        for p0 in range(0, w.shape[1] // 2, bk):
            lo = (p0 // 256) * 512 + p0 % 256
            for c in (lo, lo + 256):
                acc = acc + torch.matmul(xv[:, c:c + bk], w[:, c:c + bk].float().t())
        return acc

    t = gemm(x2, b).to(x2.dtype)
    y = gemm(t, a)
    if bias is not None:
        y = y + bias.to(x2.dtype).float()
    return y.to(x2.dtype)


def _launch_q4(x2, a4, asc, azs, b4, bsc, bzs, bias, group, form=None):
    """Launch kernel 4 in the form `_form_q4` names; `form` (measurements
    only) names another, which the launcher refuses where the shape does
    not allow it."""
    M, K = x2.shape
    N, Rp, Kp = asc.shape[0], b4.shape[0], b4.shape[1] * 2
    f32, u8 = torch.float32, torch.uint8
    _check("fused_lowrank_q4",
           x2, {"x": x2, "a4": a4, "asc": asc, "azs": azs, "b4": b4, "bsc": bsc,
                "bzs": bzs, "bias": bias},
           {"a4": u8, "b4": u8, "asc": f32, "azs": f32, "bsc": f32, "bzs": f32})
    if group % 16 or 256 % group or Rp % 512 or Kp % 512:
        raise ValueError(f"fused_lowrank_q4: group {group} (a multiple of 16 dividing "
                         f"256) with Rp {Rp} and Kp {Kp} (multiples of 512)")
    if (a4.dim() != 2 or a4.shape[0] < N or a4.shape[1] * 2 != Rp or K > Kp
            or tuple(asc.shape) != (N, Rp // group) or asc.shape != azs.shape
            or tuple(bsc.shape) != (Rp, Kp // group) or bsc.shape != bzs.shape
            or (bias is not None and tuple(bias.shape) != (N,))):
        raise ValueError(f"fused_lowrank_q4: shapes x {tuple(x2.shape)}, a4 "
                         f"{tuple(a4.shape)}, asc {tuple(asc.shape)}, b4 {tuple(b4.shape)}, "
                         f"bsc {tuple(bsc.shape)}, group {group}")
    form = form or _form_q4(M, K, x2.dtype, all(t.data_ptr() % 16 == 0 for t in (a4, b4)),
                            x2.data_ptr() % 16 == 0)
    code = _FORM_CODES.get(form, 0)
    y = _launch("fused_lowrank_q4", x2, (x2, b4, bsc, bzs, a4, asc, azs, bias),
                (M, K, Rp, Kp, N, group, code), N, Rp, split_k=code == 0)
    counter = fused_lowrank_apply_q4
    counter.launches += 1
    counter.last_form = form
    counter.form_launches[form] = counter.form_launches.get(form, 0) + 1
    return y


def fused_lowrank_apply_q4(x: torch.Tensor, a4, asc, azs, b4, bsc, bzs,
                           bias: Optional[torch.Tensor] = None, *, group: int = 128,
                           max_tokens: int = MAX_FUSED_TOKENS) -> torch.Tensor:
    """x [..., K] -> [..., N] through packed 4-bit factors (pack_int4 layout):
    a4 [>=N, Rp/2] with asc/azs [N, Rp/group]; b4 [Rp, Kp/2] with bsc/bzs
    [Rp, Kp/group]; K <= Kp."""
    K = x.shape[-1]
    N = asc.shape[0]
    lead = x.shape[:-1]
    M = _tokens(x)
    if M > max_tokens:
        a, b = _q4_factors(a4, asc, azs, b4, bsc, bzs, group, K, x.dtype)
        return lowrank_apply(x, a, b, bias)
    x2 = x.reshape(M, K)
    bias = None if bias is None else bias.to(x.dtype)
    args = (x2, a4, asc, azs, b4, bsc, bzs, bias, group)
    if x.device.type == "cuda":
        y = _launch_q4(*args)
    elif x.device.type == "cpu":
        y = fused_lowrank_q4_reference(*args)
    else:
        raise ValueError(f"fused_lowrank_q4: no kernel for device {x.device}")
    return y.reshape(*lead, N)


# launches of each CUDA kernel in this process (the plain versions and the
# large-M matmul path do not count), the form of the last launch and the
# launches by form
fused_lowrank_apply_q8.launches = 0
fused_lowrank_apply_q8.last_form = None
fused_lowrank_apply_q8.form_launches = {}
fused_lowrank_apply_q4.launches = 0
fused_lowrank_apply_q4.last_form = None
fused_lowrank_apply_q4.form_launches = {}
