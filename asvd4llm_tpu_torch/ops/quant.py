"""Round-to-nearest weight quantization of dense weights and SVD factors.

Counterpart of asvd4llm_tpu/ops/quant.py, same arithmetic in f32 (the
reference's GPTQ-derived Quantizer, ref quantization.py:17-144):
per-output-channel asymmetric min/max including zero,
``scale = (max-min)/maxq``, ``zero = round(-min/scale)``, fake-quant
``scale * (clamp(round(x/scale) + zero, 0, maxq) - zero)``, optional
per-channel MSE grid search over shrunken ranges (ref :94-111).

Also the deployment formats of the low-rank factors: int8 codes with a
per-row (scale, zero), and packed 4-bit codes with a per-(row, group)
(scale, zero_scale) whose byte layout is bit-identical to the JAX
package's (``pack_int4``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantParams(NamedTuple):
    scale: torch.Tensor  # [rows, 1] f32
    zero: torch.Tensor   # [rows, 1] f32
    maxq: int


def find_quant_params(w: torch.Tensor, bits: int, *, sym: bool = False,
                      mse: bool = False, norm: float = 2.4, grid: int = 100,
                      maxshrink: float = 0.8) -> QuantParams:
    """Per-row (output-channel) quantization ranges (ref quantization.py:52-133,
    the weight=True / perchannel=True path used by rtn_quant_sequential)."""
    maxq = 2 ** bits - 1
    flat = w.float().reshape(w.shape[0], -1)
    zeros = torch.zeros(flat.shape[0], dtype=torch.float32, device=w.device)
    xmin = torch.minimum(flat.amin(dim=1), zeros)
    xmax = torch.maximum(flat.amax(dim=1), zeros)

    if sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)

    scale = (xmax - xmin) / maxq
    if sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)

    if mse:
        # grid search shrink factor p per channel (ref quantization.py:94-111)
        best = torch.full_like(scale, float("inf"))
        for i in range(int(maxshrink * grid)):
            p = 1 - i / grid
            xmin1, xmax1 = p * xmin, p * xmax
            scale1 = (xmax1 - xmin1) / maxq
            zero1 = zero if sym else torch.round(-xmin1 / scale1)
            q = _fake_quant(flat, scale1[:, None], zero1[:, None], maxq)
            err = torch.sum((q - flat).abs() ** norm, dim=1)
            better = err < best
            best = torch.where(better, err, best)
            scale = torch.where(better, scale1, scale)
            zero = torch.where(better, zero1, zero)

    return QuantParams(scale=scale[:, None], zero=zero[:, None], maxq=maxq)


def _fake_quant(x, scale, zero, maxq):
    q = torch.clamp(torch.round(x / scale) + zero, 0, maxq)
    return scale * (q - zero)


def rtn_quantize_weight(w: torch.Tensor, bits: int, *, sym: bool = False,
                        mse: bool = False) -> torch.Tensor:
    """Fake-quantize a weight matrix (ref quantization.py:166-172:
    find_params → quantize → cast back to the original dtype)."""
    qp = find_quant_params(w, bits, sym=sym, mse=mse)
    return _fake_quant(w.float(), qp.scale, qp.zero, qp.maxq).to(w.dtype)


def quantize_to_int(w: torch.Tensor, bits: int
                    ) -> tuple[torch.Tensor, QuantParams]:
    """Real quantization: int8 codes + params for the fused q8 kernel.
    Unsigned codes 0..maxq are shifted by 2**(bits-1) into int8 range; the
    shift is folded into the returned zero point so ``dequantize`` stays
    ``scale * (q - zero)``."""
    assert bits <= 8
    qp = find_quant_params(w, bits)
    q = torch.clamp(torch.round(w.float() / qp.scale) + qp.zero, 0, qp.maxq)
    shift = 2 ** (bits - 1)
    q_signed = (q - shift).to(torch.int8)
    return q_signed, QuantParams(scale=qp.scale, zero=qp.zero - shift,
                                 maxq=qp.maxq)


def dequantize(q: torch.Tensor, qp: QuantParams,
               dtype=torch.float32) -> torch.Tensor:
    return (qp.scale * (q.float() - qp.zero)).to(dtype)


# --------------------------------------------------------------- int4 ----
#
# Real 4-bit deployment format for low-rank factors (the reference deploys
# AWQ w4 GEMM, ref quantization.py:269). Codes are 0..15, asymmetric per
# (row, col-group); two codes pack into one uint8. Columns are processed in
# INT4_COL_TILE-wide tiles; within each tile the LOW nibble of packed
# column c holds original column c of the tile's first half and the HIGH
# nibble holds column c + col_tile/2. The layout is the JAX package's, byte
# for byte (its export writes it to HF repos).

INT4_COL_TILE = 512


def _ceil_to(x, m):
    return -(-x // m) * m


def quantize_to_int4_grouped(w: torch.Tensor, group: int = 128,
                             col_tile: int = INT4_COL_TILE):
    """w [rows, cols] -> (packed uint8 [rows, colsP/2],
                          scale f32 [rows, colsP/group],
                          zero_scale f32 [rows, colsP/group])
    with colsP = cols padded to a col_tile multiple (padded groups have
    scale 0 so they dequantize to exactly 0). `group` must divide
    col_tile/2 so no group straddles a nibble-half boundary. Dequant of code
    q in (row r, group g): scale[r,g]*q - zero_scale[r,g]."""
    assert (col_tile // 2) % group == 0, (group, col_tile)
    rows, cols = w.shape
    colsP = _ceil_to(cols, col_tile)
    wp = torch.nn.functional.pad(w.float(), (0, colsP - cols))
    wg = wp.reshape(rows, colsP // group, group)
    xmin = torch.clamp(wg.amin(dim=-1), max=0.0)
    xmax = torch.clamp(wg.amax(dim=-1), min=0.0)
    degenerate = (xmax - xmin) == 0
    scale = torch.where(degenerate, 0.0, (xmax - xmin) / 15.0)
    inv = torch.where(scale == 0, 0.0,
                      1.0 / torch.where(scale == 0, 1.0, scale))
    zero = torch.round(-xmin * inv)
    q = torch.clamp(torch.round(wg * inv[..., None]) + zero[..., None], 0, 15)
    packed = pack_int4(q.reshape(rows, colsP).to(torch.uint8), col_tile)
    return packed, scale, scale * zero


def pack_int4(q: torch.Tensor, col_tile: int = INT4_COL_TILE) -> torch.Tensor:
    """q uint8 [rows, cols] (values 0..15, cols a col_tile multiple) ->
    packed uint8 [rows, cols/2] with the tile-aware split-half layout."""
    rows, cols = q.shape
    assert cols % col_tile == 0
    qt = q.reshape(rows, cols // col_tile, 2, col_tile // 2)
    return (qt[:, :, 0, :] | (qt[:, :, 1, :] << 4)).reshape(rows, cols // 2)


def unpack_int4(packed: torch.Tensor,
                col_tile: int = INT4_COL_TILE) -> torch.Tensor:
    """Inverse of pack_int4 -> uint8 codes [rows, cols]."""
    rows, colsH = packed.shape
    half = col_tile // 2
    pt = packed.reshape(rows, colsH // half, half)
    return torch.stack([pt & 15, (pt >> 4) & 15], dim=2).reshape(rows, colsH * 2)


def dequantize_int4_grouped(packed: torch.Tensor, scale: torch.Tensor,
                            zero_scale: torch.Tensor, group: int = 128,
                            col_tile: int = INT4_COL_TILE,
                            dtype=torch.float32) -> torch.Tensor:
    """packed [rows, colsP/2] (+ per-group scale/zero_scale) -> [rows, colsP]
    values, computed in f32 and rounded once to ``dtype`` (the oracle of
    the fused q4 kernel)."""
    q = unpack_int4(packed, col_tile).float()
    rows, colsP = q.shape
    qg = q.reshape(rows, colsP // group, group)
    w = qg * scale.float()[..., None] - zero_scale.float()[..., None]
    return w.reshape(rows, colsP).to(dtype)
