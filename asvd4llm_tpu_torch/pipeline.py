"""End-to-end compression pipeline (ref asvd.py:14-78).

Counterpart of asvd4llm_tpu/pipeline.py: load -> calib data -> Fisher
and/or abs stats -> sensitivity -> binary search -> [quantize] -> evaluate
-> append results.
Options that the port does not cover yet raise NotImplementedError naming
their ROADMAP queue.
"""

from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager

import numpy as np
import torch

from asvd4llm_tpu_torch.calib.fisher import calib_fisher_info
from asvd4llm_tpu_torch.calib.search import binary_search_truncation_rank
from asvd4llm_tpu_torch.calib.sensitivity import (
    calib_sensitivity_ppl, calib_sensitivity_stable_rank,
)
from asvd4llm_tpu_torch.calib.stats import calib_input_distribution
from asvd4llm_tpu_torch.config import ASVDConfig
from asvd4llm_tpu_torch.data.datasets import get_calib_data, get_eval_tokens
from asvd4llm_tpu_torch.device import resolve_device
from asvd4llm_tpu_torch.eval.ppl import evaluate_ppl_windowed
from asvd4llm_tpu_torch.ops.lowrank import align_ranks
from asvd4llm_tpu_torch.utils.cache import ArtifactCache

log = logging.getLogger(__name__)

@contextmanager
def phase(times: dict, name: str, device=None):
    """Time a phase on the host clock into ``times[name]`` (seconds); a CUDA
    device is synchronized at both ends so the time covers the device work
    the phase queued."""
    sync = torch.device(device).type == "cuda" if device is not None else False
    if sync:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            torch.cuda.synchronize(device)
        times[name] = time.perf_counter() - t0
        log.info("phase %s: %.2fs", name, times[name])


def check_supported(cfg: ASVDConfig) -> None:
    """Raise for configuration values the port does not run yet."""
    unsupported = [
        (cfg.calib_dataset == "selfgen", "calib_dataset='selfgen'", "item 6"),
        (int(np.prod(cfg.mesh_shape)) > 1, f"mesh_shape={cfg.mesh_shape}", "item 7"),
        (cfg.max_host_rss_gb > 0,
         f"max_host_rss_gb={cfg.max_host_rss_gb} (a host-RSS budget that "
         "recycles the process; utils/hostguard.py is not ported)", "item 8"),
        (bool(cfg.eval_tasks) or cfg.eval_mmlu, "task evaluation", "item 6"),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is still to port (ROADMAP queue 1, {item})")


def compress(params, spec, tokenizer, cfg: ASVDConfig, *, vocab_size=None,
             times=None, scan_log=None):
    """Calibration + sensitivity + search; returns
    (compressed_params, manifest, artifacts dict). Phase seconds go into
    ``times`` when given, and the suffix scan's per-leaf records (backend,
    SVD and evaluation seconds) into ``scan_log``.

    ``cfg.scan_resume_path`` (JAX pipeline.py:109-133): the scan appends
    each finished leaf to that JSONL file and a rerun replays the leaves it
    finds there; the search checkpoints each leaf's factors under
    ``<path>.factors``."""
    check_supported(cfg)
    times = {} if times is None else times
    dev = params["embed_tokens"].device
    cache = ArtifactCache(cfg.cache_dir, enabled=cfg.use_cache)
    with phase(times, "calib_data"):
        calib_loader = get_calib_data(
            cfg.calib_dataset, tokenizer, cfg.model_id, cfg.n_calib_samples,
            seqlen=cfg.seqlen, seed=cfg.seed, use_bos=cfg.use_bos,
            cache_dir=cfg.cache_dir, use_cache=cfg.use_cache,
            vocab_size=vocab_size or spec.vocab_size,
            fixed_alpaca_template=cfg.fixed_alpaca_template)

    fisher = None
    stats = None
    if "fisher" in cfg.scaling_method:
        with phase(times, "calib_fisher", dev):
            fisher = calib_fisher_info(params, spec, calib_loader, cache=cache,
                                       cache_key=cfg.calib_key(),
                                       include_extras=cfg.compress_all_linears,
                                       double_shift=cfg.fisher_double_shift)
    if "abs" in cfg.scaling_method:
        with phase(times, "calib_stats", dev):
            stats = calib_input_distribution(params, spec, calib_loader,
                                             cfg.scaling_method, cache=cache,
                                             cache_key=cfg.calib_key())

    resume = cfg.scan_resume_path or None
    with phase(times, "sensitivity", dev):
        if cfg.sensitivity_metric == "ppl":
            sensitivity = calib_sensitivity_ppl(params, spec, calib_loader, cfg,
                                                stats=stats, fisher=fisher,
                                                cache=cache, resume=resume,
                                                scan_log=scan_log)
        else:
            sensitivity = calib_sensitivity_stable_rank(params, spec,
                                                        calib_loader, cfg,
                                                        cache=cache)

    with phase(times, "binary_search", dev):
        compressed, manifest = binary_search_truncation_rank(
            params, spec, sensitivity, calib_loader, cfg, stats=stats,
            fisher=fisher,
            resume_dir=(resume + ".factors") if resume else None)

    if cfg.weight_quant != "none":
        from asvd4llm_tpu_torch.ops.quant_apply import quantize_model_weights
        with phase(times, "weight_quant", dev):
            compressed = quantize_model_weights(compressed, spec,
                                                cfg.weight_quant, stats=stats)

    if cfg.deploy_int8_factors:
        from asvd4llm_tpu_torch.ops.quant_apply import quantize_lowrank_factors_int8
        with phase(times, "deploy_int8", dev):
            compressed = quantize_lowrank_factors_int8(compressed, spec)

    if cfg.deploy_int4_factors:
        from asvd4llm_tpu_torch.ops.quant_apply import quantize_lowrank_factors_int4
        with phase(times, "deploy_int4", dev):
            compressed = quantize_lowrank_factors_int4(
                compressed, spec, group=cfg.int4_group_size, stats=stats)

    artifacts = {"stats": stats, "fisher": fisher, "sensitivity": sensitivity,
                 "calib_loader": calib_loader}
    return compressed, manifest, artifacts


def evaluate(params, spec, tokenizer, cfg: ASVDConfig, *, times=None) -> dict:
    """PPL on the cfg.eval_ppl datasets, low-rank and quantized leaves
    through the fused kernels when cfg.use_pallas (low-rank ranks then
    zero-padded to the kernels' multiple, ``align_ranks``, exact). Phase
    seconds go into ``times`` when given."""
    check_supported(cfg)
    if cfg.use_pallas:
        params = align_ranks(params, spec)
    times = {} if times is None else times
    results: dict = {}
    if cfg.eval_ppl:
        dev = params["embed_tokens"].device
        for ds in cfg.eval_ppl.split(","):
            toks = get_eval_tokens(ds, tokenizer, cache_dir=cfg.cache_dir,
                                   use_cache=cfg.use_cache,
                                   vocab_size=spec.vocab_size,
                                   model_id=cfg.model_id)
            bos_id = getattr(tokenizer, "bos_token_id", 0) or 0
            with phase(times, f"eval_{ds}", dev):
                ppl = evaluate_ppl_windowed(params, spec, toks,
                                            seqlen=cfg.seqlen,
                                            use_bos=cfg.use_bos,
                                            bos_token_id=bos_id,
                                            use_pallas=cfg.use_pallas)
            log.info("%s ppl: %.4f", ds, ppl)
            results[ds] = ppl
    return results


def write_results(cfg: ASVDConfig, results: dict, manifest=None):
    """Append to output/result.txt (reference format, ref asvd.py:71-75)
    plus a structured JSONL record."""
    os.makedirs(cfg.output_dir, exist_ok=True)
    with open(os.path.join(cfg.output_dir, "result.txt"), "a+") as f:
        f.write(f"{cfg.to_dict()}\n")
        f.write(f"{results}\n")
    with open(os.path.join(cfg.output_dir, "results.jsonl"), "a+") as f:
        rec = {"time": time.time(), "config": cfg.to_dict(),
               "results": results}
        if manifest is not None:
            rec["n_compressed_layers"] = len(manifest)
            rec["manifest"] = manifest
        f.write(json.dumps(rec) + "\n")


def run(cfg: ASVDConfig, *, device=None) -> dict:
    """Full pipeline from a local checkpoint directory on ``device``
    (``cuda:0`` unless the caller names another). Returns
    {"results": {dataset: ppl}, "manifest": {name: rank} | None,
    "params": compressed params, "spec": spec, "phase_times": {...}}."""
    from asvd4llm_tpu_torch.models.loader import load_model

    check_supported(cfg)
    device = resolve_device(device)
    np.random.seed(cfg.seed)
    times: dict = {}
    with phase(times, "load_model", device):
        params, spec, tokenizer = load_model(cfg.model_id, dtype=cfg.eval_dtype,
                                             device=device)
    manifest = None
    if not cfg.raw_model:
        params, manifest, _ = compress(params, spec, tokenizer, cfg,
                                       times=times)
    results = evaluate(params, spec, tokenizer, cfg, times=times)
    log.info("results: %s", results)
    write_results(cfg, results, manifest)
    return {"results": results, "manifest": manifest, "params": params,
            "spec": spec, "phase_times": times}
