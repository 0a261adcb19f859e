"""AWQ-style activation-aware weight quantization (fake-quant).

Counterpart of asvd4llm_tpu/ops/awq.py, same arithmetic in f32 (the
reference's AWQ bridge, ref quantization.py:178-283): a per-input-channel
scale s from activation magnitudes, W·diag(s) quantized group-wise, the
compensation folded back analytically as Q(W·s)/s. Low-rank layers quantize
BOTH factors; the A factor's search is driven by rank-dim latent statistics
(the reference's BLinear→ALinear scale pair). Groups of 128 along the input
dim, asymmetric with a zero point, 4 or 8 bits (ref :269). The scale grid
search minimizes sum_j E[x_j]^2 * (W_hat - W)_{:,j}^2 over alpha in [0, 1).
"""

from __future__ import annotations

import logging

import torch

from asvd4llm_tpu_torch.models.registry import is_lowrank, iter_linears, set_linear

log = logging.getLogger(__name__)

N_GRID = 20


def groupwise_fake_quant(w: torch.Tensor, bits: int, group_size: int = 128
                         ) -> torch.Tensor:
    """Asymmetric min-max fake-quant in groups of `group_size` along the
    input dim (AWQ GEMM config, ref quantization.py:269)."""
    out_f, in_f = w.shape
    g = min(group_size, in_f)
    wp = torch.nn.functional.pad(w.float(), (0, (-in_f) % g))
    wg = wp.reshape(out_f, -1, g)
    maxq = 2 ** bits - 1
    xmin = torch.clamp(wg.amin(dim=-1, keepdim=True), max=0)
    xmax = torch.clamp(wg.amax(dim=-1, keepdim=True), min=0)
    degenerate = (xmax - xmin) == 0
    scale = torch.where(degenerate, 1.0, (xmax - xmin) / maxq)
    zero = torch.round(-xmin / scale)
    q = torch.clamp(torch.round(wg / scale) + zero, 0, maxq)
    wq = (scale * (q - zero)).reshape(out_f, -1)[:, :in_f]
    return wq.to(w.dtype)


@torch.no_grad()
def awq_search_and_quant(w: torch.Tensor, act_mean: torch.Tensor, *, bits: int,
                         group_size: int = 128) -> torch.Tensor:
    """Grid-search the AWQ scale exponent and return the fake-quantized
    weight Q(W·s)/s at the best alpha (alpha = 0 is plain group RTN)."""
    w32 = w.float()
    x = torch.clamp(act_mean.float(), min=1e-8)
    importance = x ** 2  # E[x_j]^2 proxy for output error weighting

    def err_at(wq):
        return torch.sum((wq.float() - w32) ** 2 * importance[None, :])

    best_w = groupwise_fake_quant(w32, bits, group_size)
    best_err = err_at(best_w)
    for i in range(1, N_GRID):
        s = x ** (i / N_GRID)
        s = s / torch.exp(torch.mean(torch.log(s)))  # geo-mean 1
        wq = groupwise_fake_quant(w32 * s[None, :], bits, group_size) / s[None, :]
        e = err_at(wq)
        best_w = torch.where(e < best_err, wq, best_w)
        best_err = torch.minimum(e, best_err)
    return best_w.to(w.dtype)


def _latent_abs_mean(leaf, act_mean):
    """Approximate E|t| of the rank-dim latent t = x @ B.T from the input
    statistics: E|t_r| ≈ sum_j |B_rj| E|x_j| (triangle-inequality proxy;
    stats collected under '<layer>.ALinear' are used instead when given)."""
    return leaf["B"].float().abs() @ act_mean.float()


def awq_quantize_model(params, spec, bits: int, *, stats=None,
                       group_size: int = 128):
    """Quantize every decoder linear (dense weights and BOTH low-rank
    factors) with AWQ scale search. `stats`: {name: abs_mean}; entries named
    '<layer>.ALinear' are used for A factors when present, else
    approximated from B."""
    stats = stats or {}
    out = params
    n = 0
    for name, leaf in iter_linears(params, spec):
        new = dict(leaf)
        if is_lowrank(leaf):
            x_b = stats.get(name)
            if x_b is None:
                x_b = torch.ones(leaf["B"].shape[1], device=leaf["B"].device)
            x_a = stats.get(name + ".ALinear")
            if x_a is None:
                x_a = _latent_abs_mean(leaf, x_b)
            new["B"] = awq_search_and_quant(leaf["B"], x_b, bits=bits,
                                            group_size=group_size)
            new["A"] = awq_search_and_quant(leaf["A"], x_a, bits=bits,
                                            group_size=group_size)
        else:
            x = stats.get(name)
            if x is None:
                x = torch.ones(leaf["w"].shape[1], device=leaf["w"].device)
            new["w"] = awq_search_and_quant(leaf["w"], x, bits=bits,
                                            group_size=group_size)
        out = set_linear(out, spec, name, new)
        n += 1
    log.info("awq int%d quantized %d linears (group_size=%d)", bits, n,
             group_size)
    return out
