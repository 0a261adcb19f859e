"""Per-layer sensitivity scanning.

Counterpart of the serial scan of asvd4llm_tpu/calib/sensitivity.py
(``calib_sensitivity_ppl`` with ``batch_ratios=False``, :899-959) and of
``calib_sensitivity_stable_rank`` (:962-994). Reference behavior (ref
sensitivity.py:10-61): for every linear and every candidate ratio
([0.4..0.9] for weights, [0.1..1.9] in KV mode), factorize THAT ONE layer
(always act-aware, ref :50), measure calibration PPL, restore. Result:
{layer_full_name: {ratio: ppl}}.

One SVD per layer serves every ratio of the grid: truncating the max-rank
factorization at r IS the rank-r ASVD solution, and the candidate is
substituted as a same-shaped dense leaf w = A @ B. The JAX package's
prefix-cached scan-stacked evaluator, per-leaf resume and OOM retry wait
for a later slice (ROADMAP queue 1); their numbers are the same.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict

import numpy as np
import torch

from asvd4llm_tpu_torch.eval.ppl import evaluate_perplexity
from asvd4llm_tpu_torch.models.registry import (
    dense_leaf, get_linear, iter_linears, leaf_shape, set_linear,
)
from asvd4llm_tpu_torch.ops.asvd import (
    build_scaling_vector, rank_for_param_ratio, scaled_svd,
)
from asvd4llm_tpu_torch.ops.svd import singular_values

log = logging.getLogger(__name__)

WEIGHT_RATIO_GRID = [0.4, 0.5, 0.6, 0.7, 0.8, 0.9]          # ref :39
KV_RATIO_GRID = [0.1 * i for i in range(1, 20)]               # ref :37
STABLE_RANK_GRID = [0.1 * i for i in range(1, 10)]            # ref :90


def recomposed_dense_all_ratios(w, bias, ratios, scale, rank_align,
                                svd_backend, generator):
    """{ratio: dense leaf w_hat = U_r S_r Vh_r, or None} from ONE SVD at the
    grid's largest rank. None marks rank 0 or a non-finite recomposition."""
    out_f, in_f = w.shape
    ranks = {r: min(rank_for_param_ratio(in_f, out_f, r, rank_align),
                    in_f, out_f)
             for r in ratios}
    max_rank = max(ranks.values())
    if max_rank <= 0:
        return {r: None for r in ratios}
    u, s, vh = scaled_svd(w, max_rank, scale=scale, backend=svd_backend,
                          generator=generator)
    out = {}
    for r, rank in ranks.items():
        if rank <= 0:
            out[r] = None
            continue
        w_hat = ((u[:, :rank] * s[:rank][None, :]) @ vh[:rank, :]).to(w.dtype)
        out[r] = dense_leaf(w_hat, bias) if bool(torch.isfinite(w_hat).all()) \
            else None
    return out


def calib_sensitivity_ppl(params, spec, calib_loader, cfg, *, stats=None,
                          fisher=None, cache=None,
                          generator: torch.Generator | None = None) -> dict:
    """{full_name: {ratio: ppl}} via single-layer decompose + calib PPL
    (ref sensitivity.py:10-61). Always act-aware (ref :50). A leaf with no
    valid ratio (every rank 0 or non-finite) records inf at every ratio and
    is skipped."""
    if cache is not None:
        hit = cache.load_sensitivity(cfg.sensitivity_key())
        if hit is not None:
            log.info("sensitivity cache hit (%s)", cfg.sensitivity_key())
            return hit

    grid = KV_RATIO_GRID if cfg.compress_kv_cache else WEIGHT_RATIO_GRID
    input_ids = np.concatenate(
        [np.asarray(b["input_ids"]) for b in calib_loader], axis=0)
    include_extras = getattr(cfg, "compress_all_linears", True)
    if generator is None:
        generator = torch.Generator(device=params["embed_tokens"].device)
        generator.manual_seed(cfg.seed)

    sensitivity: dict = {}
    t0 = time.time()
    n_pts = 0
    for name, leaf in iter_linears(params, spec, include_extras):
        if "A" in leaf:
            continue  # already low-rank; the reference scans raw models only
        scale = build_scaling_vector(
            None if stats is None else stats.get(name),
            None if fisher is None else fisher.get(name), cfg.alpha)
        leaves = recomposed_dense_all_ratios(
            leaf["w"], leaf["b"], grid, scale, cfg.rank_align,
            cfg.svd_backend, generator)
        valid = [r for r in grid if leaves[r] is not None]
        # rank 0 / non-finite: infinitely sensitive at that ratio (entered
        # first, in the JAX package's order: the search's stable sort sees it)
        sensitivity[name] = {r: float("inf") for r in set(grid) - set(valid)}
        for ratio in valid:
            trial = set_linear(params, spec, name, leaves[ratio])
            sensitivity[name][ratio] = evaluate_perplexity(
                trial, spec, input_ids, cfg.n_calib_samples)
            n_pts += 1
        log.info("sensitivity %s done (%d pts, %.1fs elapsed)",
                 name, n_pts, time.time() - t0)

    if cache is not None:
        cache.save_json("sensitivity", cfg.sensitivity_key(), sensitivity)
    return sensitivity


@torch.no_grad()
def calib_sensitivity_stable_rank(params, spec, calib_loader, cfg,
                                  cache=None) -> dict:
    """Forward-free proxy (ref sensitivity.py:64-110): per layer,
    sr = (||W||_F^2 / sigma_max^2)^0.5, score[ratio] = -sr * ratio**0.1.
    Same-shaped weights take one batched SVD."""
    key_name = "sensitivity_stable_rank"
    if cache is not None:
        raw = cache.load_json(key_name, cfg.sensitivity_key())
        if raw is not None:
            return {n: {float(r): p for r, p in d.items()} for n, d in raw.items()}

    buckets: dict = defaultdict(list)
    for name, leaf in iter_linears(params, spec,
                                   getattr(cfg, "compress_all_linears", True)):
        if "A" in leaf:
            continue
        buckets[leaf_shape(leaf)].append((name, leaf["w"]))

    sensitivity: dict = {}
    for _, items in buckets.items():
        ws = torch.stack([w for _, w in items]).float()
        svs = singular_values(ws)                             # [L, min(m,n)]
        fro2 = (ws * ws).sum(dim=(1, 2))
        sr = torch.sqrt(fro2 / (svs[:, 0] ** 2))
        for (name, _), sr_i in zip(items, sr.cpu().numpy()):
            sensitivity[name] = {r: float(-sr_i * r ** 0.1)
                                 for r in STABLE_RANK_GRID}

    if cache is not None:
        cache.save_json(key_name, cfg.sensitivity_key(), sensitivity)
    return sensitivity
