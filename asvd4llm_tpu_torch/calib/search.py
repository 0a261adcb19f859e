"""Binary-search rank allocation (ref binary_search.py:10-131).

Counterpart of asvd4llm_tpu/calib/search.py, step by step:
- flatten the sensitivity dict to (layer, ratio, ppl) triples in the
  reference's module-walk order, dropping ratio >= 1 in weight mode
  (ref :42-48);
- stable sort by ppl DESCENDING (ref :49);
- binary-search a cut index `mid`: the trial assigns each layer the MINIMUM
  ratio among its entries in sorted_list[mid:], default 1 (weights) or 2
  (KV mode, ref :29-36,94-96);
- feasibility: the naive-float total ratio (KV mode: /2) against the target
  (ref :88-102), or in ppl-target mode the calibration PPL of every layer
  decomposed (ref :64-87);
- the final pass decomposes every layer whose ratio != default into
  two-factor low-rank leaves (ref :104-131), each leaf's max-rank SVD
  dropped after its last use; with ``resume_dir`` each leaf's factors are
  checkpointed as ``<resume_dir>/<name>.npz`` in the JAX package's layout
  (JAX :274-318), so a rerun reloads finished leaves.

Returns (new_params, manifest {layer_name: rank}).
"""

from __future__ import annotations

import logging
import os
import time
import zipfile

import numpy as np
import torch

from asvd4llm_tpu_torch.calib.sensitivity import split_generator
from asvd4llm_tpu_torch.eval.ppl import evaluate_perplexity
from asvd4llm_tpu_torch.models.registry import (
    dense_leaf, get_linear, leaf_shape, lowrank_leaf, reference_walk_order,
    set_linear,
)
from asvd4llm_tpu_torch.ops.asvd import (
    LowRankFactors, build_scaling_vector, fuse_sigma, rank_for_param_ratio,
    scaled_svd,
)

log = logging.getLogger(__name__)


def naive_compressed_params(numels: dict, ratios: dict) -> tuple:
    """(compressed, total) params via naive `+=` float accumulation in dict
    order, as the reference's loop does (ref binary_search.py:90-93): at a
    knife-edge target the last ulp decides the branch, and Python 3.12's
    compensated sum() would decide it differently."""
    tot = 0
    comp = 0
    for n, r in ratios.items():
        tot += numels[n]
        comp += numels[n] * r
    return comp, tot


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A factor as numpy; bf16, which numpy lacks, goes up to f32
    (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A checkpointed factor on ``like``'s device and dtype. The JAX
    package writes bf16 factors as 2-byte void records (ml_dtypes'
    bfloat16); their bits are read as bf16."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=like.device, dtype=like.dtype)


def load_factors(path, like):
    """(leaf, rank) from a factor checkpoint, or None when it is missing or
    torn (then the leaf is recomputed)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            bias = _from_numpy(z["bias"], like) if "bias" in z.files else None
            leaf = lowrank_leaf(_from_numpy(z["a"], like), _from_numpy(z["b"], like),
                                bias)
            return leaf, int(z["rank"])
    except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile) as e:
        # a torn file from a kill: recompute
        log.warning("decompose resume: unreadable %s (%s), recomputing", path, e)
        return None


def save_factors(path, f: LowRankFactors):
    """Write one leaf's factors atomically: a ``.tmp.npz`` replaced onto
    ``path``, so a kill never leaves a torn checkpoint."""
    arrs = {"a": _to_numpy(f.A), "b": _to_numpy(f.B), "rank": np.int64(f.rank)}
    if f.bias is not None:
        arrs["bias"] = _to_numpy(f.bias)
    tmp = path + ".tmp.npz"   # np.savez appends .npz to a bare name
    np.savez(tmp, **arrs)
    os.replace(tmp, path)


def binary_search_truncation_rank(params, spec, sensitivity_dict,
                                  calib_loader, cfg, *, stats=None,
                                  fisher=None,
                                  generator: torch.Generator | None = None,
                                  resume_dir=None):
    """Returns (compressed_params, manifest {name: rank}). ``resume_dir``:
    per-leaf factor checkpoints of the final pass (see the module
    docstring). Each SVD draws its leaf's own generator, split from
    ``generator`` whether the leaf is computed or loaded."""
    if cfg.compress_kv_cache:
        ratio_target = cfg.kv_cache_ratio_target
        sensitivity_dict = {k: v for k, v in sensitivity_dict.items()
                            if "k_proj" in k or "v_proj" in k}
        assert cfg.ppl_target < 0, \
            "ppl_target is not supported when compressing kv_cache"
        default_param_ratio = 2
    else:
        ratio_target = cfg.param_ratio_target
        default_param_ratio = 1

    log.info("=== %s target: ppl=%s, ratio_target=%s ===",
             "compress kv_cache" if cfg.compress_kv_cache else "compress weight",
             cfg.ppl_target, ratio_target)

    # the stable sort's tie-break and the naive accumulation both depend on
    # dict order: walk in the reference's module order
    sensitivity_dict = {
        name: sensitivity_dict[name]
        for name in reference_walk_order(params, spec, list(sensitivity_dict))}

    sensitivity_list = []
    for layername, v in sensitivity_dict.items():
        for param_ratio, ppl in v.items():
            if not cfg.compress_kv_cache and param_ratio >= 1:
                continue  # ref :45-47
            sensitivity_list.append((layername, param_ratio, ppl))
    sorted_list = sorted(sensitivity_list, key=lambda x: -x[2])

    assert cfg.ppl_target > 0 or ratio_target > 0, (
        "set one of --ppl_target / --param_ratio_target / "
        "--kv_cache_ratio_target (ref binary_search.py:54)")

    shapes = {name: leaf_shape(get_linear(params, spec, name))
              for name in sensitivity_dict}
    numels = {name: s[0] * s[1] for name, s in shapes.items()}
    input_ids = None
    svd_cache: dict = {}
    if cfg.ppl_target > 0:
        input_ids = np.concatenate(
            [np.asarray(b["input_ids"]) for b in calib_loader], axis=0)
    if generator is None:
        generator = torch.Generator(device=params["embed_tokens"].device)
        generator.manual_seed(cfg.seed)

    def config_at(mid):
        ratios = {name: default_param_ratio for name in sensitivity_dict}
        for layername, r, _ in sorted_list[mid:]:
            ratios[layername] = min(ratios[layername], r)
        return ratios

    def _rank(name, r):
        out_f, in_f = shapes[name]
        return min(rank_for_param_ratio(in_f, out_f, r, cfg.rank_align),
                   in_f, out_f)

    def _layer_svd(name, sub):
        """Per-layer max-rank SVD, computed once and truncated per trial and
        for the final pass (truncating it at r IS the rank-r solution)."""
        ent = svd_cache.get(name)
        if ent is not None:
            return ent
        leaf = get_linear(params, spec, name)
        # KV mode's grid runs past 1.0 (to 1.9): every grid ratio and the
        # default ratio may be requested
        cand = list(sensitivity_dict[name]) + [1.0, default_param_ratio]
        max_rank = max(_rank(name, r) for r in cand)
        scale = None
        if cfg.act_aware:
            scale = build_scaling_vector(
                None if stats is None else stats.get(name),
                None if fisher is None else fisher.get(name), cfg.alpha)
        u, s, vh = scaled_svd(leaf["w"], max(max_rank, 1), scale=scale,
                              backend=cfg.svd_backend, generator=sub)
        ent = (u, s, vh, leaf)
        svd_cache[name] = ent
        return ent

    def _trial_dense(name, r, sub):
        rank = _rank(name, r)
        if rank <= 0:
            return None
        u, s, vh, leaf = _layer_svd(name, sub)
        w_hat = ((u[:, :rank] * s[:rank][None, :]) @ vh[:rank, :]
                 ).to(leaf["w"].dtype)
        if not bool(torch.isfinite(w_hat).all()):
            return None
        return dense_leaf(w_hat, leaf["b"])

    low, high = 0, len(sorted_list) - 1
    mid = (low + high) // 2
    while low < high:
        mid = (low + high) // 2
        ratios = config_at(mid)
        comp, tot = naive_compressed_params(numels, ratios)
        if cfg.ppl_target > 0:
            # like the reference (binary_search.py:66-79) the trial
            # factorizes EVERY layer, ratio-1.0 ones included
            trial = params
            for name, r in ratios.items():
                new_leaf = _trial_dense(name, r, split_generator(generator))
                if new_leaf is not None:
                    trial = set_linear(trial, spec, name, new_leaf)
            ppl = evaluate_perplexity(trial, spec, input_ids,
                                      cfg.n_calib_samples)
            log.info("low=%d mid=%d high=%d ppl=%.4f param_ratio=%.4f",
                     low, mid, high, ppl, comp / tot)
            if ppl < cfg.ppl_target:
                high = mid
            else:
                low = mid + 1
        else:
            now_ratio = comp / tot
            if cfg.compress_kv_cache:
                now_ratio /= 2  # ref :94-96
            log.info("low=%d mid=%d high=%d now_ratio=%.4f params=(%d/%d)",
                     low, mid, high, now_ratio, comp, tot)
            if now_ratio > ratio_target:
                high = mid
            else:
                low = mid + 1

    def _factors(name, r, sub):
        """Final-pass factors: the cached max-rank SVD truncated at r, the
        same factorization the ppl-target trials evaluated."""
        rank = _rank(name, r)
        if rank <= 0:
            return None
        u, s, vh, leaf = _layer_svd(name, sub)
        a, b_f = fuse_sigma(u[:, :rank], s[:rank], vh[:rank, :], cfg.sigma_fuse)
        a = a.to(leaf["w"].dtype).contiguous()
        b_f = b_f.to(leaf["w"].dtype).contiguous()
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b_f).all())):
            return None
        return LowRankFactors(a, b_f, leaf["b"])

    # final decomposition at the last computed mid (ref :104-131 reuses
    # `mid` from the loop, quirk kept)
    log.info("=== Searching done, decomposing layers... ===")
    ratios = config_at(mid)
    t0 = time.time()
    manifest: dict = {}
    out = params
    if resume_dir is not None:
        os.makedirs(resume_dir, exist_ok=True)
    n_loaded = 0
    for name, r in ratios.items():
        if r == default_param_ratio:
            continue
        sub = split_generator(generator)
        ck = None if resume_dir is None else os.path.join(resume_dir, name + ".npz")
        hit = None if ck is None else \
            load_factors(ck, get_linear(params, spec, name)["w"])
        if hit is not None:
            out = set_linear(out, spec, name, hit[0])
            manifest[name] = hit[1]
            n_loaded += 1
            continue
        f = _factors(name, r, sub)
        # its last consumer: one cached factorization at a time, not every
        # compressed leaf's (about 23 GB at Llama-2-7B's 32 layers)
        svd_cache.pop(name, None)
        if f is None:
            log.warning("factorization unusable for %s at ratio %s; "
                        "keeping dense layer", name, r)
            continue
        out = set_linear(out, spec, name, lowrank_leaf(f.A, f.B, f.bias))
        manifest[name] = f.rank
        if ck is not None:
            save_factors(ck, f)
        o, i = shapes[name]
        if cfg.compress_kv_cache and f.rank >= min(o, i):
            log.warning("%s: rank_align=%d rounded rank to the full "
                        "dimension (%d) — no realized KV compression for "
                        "this layer", name, cfg.rank_align, f.rank)
    log.info("decompose time: %.2fs (%d layers, %d from resume checkpoints)",
             time.time() - t0, len(manifest), n_loaded)
    return out, manifest
