"""Model-level quantization: fake-quant evaluation modes and the two
deployment conversions of the low-rank factors.

Counterpart of asvd4llm_tpu/ops/quant_apply.py. ``quantize_model_weights``
mirrors ``rtn_quant_sequential`` (ref quantization.py:156-175): every
linear inside every decoder layer, both factors of low-rank leaves, is
fake-quantized; embeddings, norms and lm_head stay as they are. The
deployment conversions turn every low-rank leaf, lm_head included, into
real int8 or packed int4 codes that ``models/decoder.apply_linear`` sends
through the fused quantized kernels (ops/fused_lowrank_q.py).
"""

from __future__ import annotations

import logging

import torch

from asvd4llm_tpu_torch.models.registry import (
    is_lowrank, iter_linears, q4_lowrank_leaf, q8_lowrank_leaf, set_linear,
)
from asvd4llm_tpu_torch.ops.quant import (
    quantize_to_int, quantize_to_int4_grouped, rtn_quantize_weight,
)

log = logging.getLogger(__name__)

_BITS = {"rtn_int8": 8, "rtn_int6": 6, "rtn_int4": 4}


def quantize_lowrank_factors_int8(params, spec):
    """Every low-rank leaf's factors to int8 codes + per-row scale and zero
    (the q8 deployment format)."""
    out = params
    n = 0
    for name, leaf in iter_linears(params, spec, include_extras=True):
        if not is_lowrank(leaf):
            continue
        a8, aq = quantize_to_int(leaf["A"], 8)
        b8, bq = quantize_to_int(leaf["B"], 8)
        out = set_linear(out, spec, name, q8_lowrank_leaf(
            a8, aq.scale, aq.zero, b8, bq.scale, bq.zero, leaf["b"]))
        n += 1
    log.info("converted %d low-rank leaves to int8 deployment format", n)
    return out


def quantize_lowrank_factors_int4(params, spec, *, group: int = 128,
                                  stats=None, awq_fold: bool = True):
    """Every low-rank leaf's factors to packed 4-bit codes + per-(row, group)
    scales (the q4 deployment format; the reference deploys AWQ w4 GEMM,
    ref quantization.py:269).

    awq_fold: AWQ's scale trick applied exactly on the rank dimension (the
    reference's prev_op=BLinear, layers=[ALinear] pair, ref
    quantization.py:190-204): a per-rank scale s from latent magnitudes,
    A·diag(s) quantized, diag(1/s) folded into B. B's own input channels
    have no foldable previous op here, so B is grouped RTN."""
    from asvd4llm_tpu_torch.ops.awq import _latent_abs_mean

    stats = stats or {}
    out = params
    n = 0
    for name, leaf in iter_linears(params, spec, include_extras=True):
        if not is_lowrank(leaf):
            continue
        a, b = leaf["A"], leaf["B"]
        if awq_fold:
            x_b = stats.get(name)
            if x_b is None:
                x_b = torch.ones(b.shape[1], device=b.device)
            s = torch.sqrt(torch.clamp(_latent_abs_mean(leaf, x_b), min=1e-8))
            s = s / torch.exp(torch.mean(torch.log(s)))  # geo-mean 1
            a = (a.float() * s[None, :]).to(a.dtype)
            b = (b.float() / s[:, None]).to(b.dtype)
        # both factors group along their INPUT dim: A along the rank, B
        # along the model channels
        a4, asc, azs = quantize_to_int4_grouped(a, group=group)
        b4, bsc, bzs = quantize_to_int4_grouped(b, group=group)
        # pad B's rows to the packed rank Rp so that A's packed columns and
        # B's rows agree (the kernel's t spans Rp)
        pad = a4.shape[1] * 2 - b4.shape[0]
        if pad:
            b4, bsc, bzs = (torch.nn.functional.pad(v, (0, 0, 0, pad))
                            for v in (b4, bsc, bzs))
        out = set_linear(out, spec, name, q4_lowrank_leaf(
            a4, asc, azs, b4, bsc, bzs, leaf["b"]))
        n += 1
    log.info("converted %d low-rank leaves to int4 deployment format "
             "(group=%d, awq_fold=%s)", n, group, awq_fold)
    return out


def quantize_model_weights(params, spec, weight_quant: str, *, stats=None):
    """Fake-quantize every decoder linear: ``rtn_int{8,6,4}`` per output
    channel, ``awq_int{8,4}`` with the AWQ scale search."""
    if weight_quant.startswith("awq"):
        from asvd4llm_tpu_torch.ops.awq import awq_quantize_model
        bits = 8 if weight_quant == "awq_int8" else 4
        return awq_quantize_model(params, spec, bits, stats=stats)
    bits = _BITS[weight_quant]
    out = params
    for name, leaf in iter_linears(params, spec):
        new = dict(leaf)
        for key in (("A", "B") if is_lowrank(leaf) else ("w",)):
            new[key] = rtn_quantize_weight(leaf[key], bits)
        out = set_linear(out, spec, name, new)
    log.info("rtn int%d quantized all decoder linears", bits)
    return out
