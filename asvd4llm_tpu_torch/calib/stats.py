"""Activation-statistics calibration (abs_mean / abs_max).

Counterpart of asvd4llm_tpu/calib/stats.py: the reference's forward hooks
(ref act_aware_utils.py:47-95) become a statistics-collecting forward.
Accumulation semantics match the hooks:

- abs_mean: sum over calibration samples of the per-sample mean over the
  sequence axis of |input| (ref :65-67; NOT divided by n),
- abs_max: running elementwise max over samples and positions (ref :68-74).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from asvd4llm_tpu_torch.models.decoder import forward_with_stats

log = logging.getLogger(__name__)


def _stacked_batches(calib_loader, batch_size: int):
    """Group same-length samples into [B, L] batches. Valid because both
    reductions are per-sample-then-combine (sum / max)."""
    by_len: dict = {}
    for b in calib_loader:
        ids = np.asarray(b["input_ids"]).reshape(-1)
        by_len.setdefault(len(ids), []).append(ids)
    for _, rows in by_len.items():
        for i in range(0, len(rows), batch_size):
            yield np.stack(rows[i:i + batch_size])


@torch.no_grad()
def calib_input_distribution(params, spec, calib_loader, method: str,
                             cache=None, cache_key: str = "",
                             batch_size: int = 8) -> dict:
    """Run calibration forwards; return {linear_name: [in_features] f32}
    on the params' device. `method` may be "abs_mean", "abs_max" or the
    reference's composite strings (substring match, ref
    act_aware_utils.py:65-69)."""
    if "abs_mean" in method:
        mode = "abs_mean"
    elif "abs_max" in method:
        mode = "abs_max"
    else:
        raise ValueError(f"unknown scaling method {method!r}")

    dev = params["embed_tokens"].device
    if cache is not None:
        hit = cache.load_arrays(f"calib_{mode}", cache_key)
        if hit is not None:
            log.info("calibration stats cache hit (%s)", cache_key)
            return {k: torch.as_tensor(v, device=dev) for k, v in hit.items()}

    acc: dict = {}
    for ids_np in _stacked_batches(calib_loader, batch_size):
        _, stats = forward_with_stats(params, torch.as_tensor(ids_np, device=dev),
                                      spec, collect=mode)
        for k, v in stats.items():
            if k not in acc:
                acc[k] = v
            elif mode == "abs_mean":
                acc[k] = acc[k] + v
            else:
                acc[k] = torch.maximum(acc[k], v)

    if cache is not None:
        cache.save_arrays(f"calib_{mode}", cache_key,
                          {k: v.cpu().numpy() for k, v in acc.items()})
    return acc
