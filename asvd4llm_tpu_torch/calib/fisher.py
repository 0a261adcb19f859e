"""Fisher-information calibration.

Counterpart of asvd4llm_tpu/calib/fisher.py (ref act_aware_utils.py:8-44):
per calibration batch, forward with labels = input ids shifted by one, mean
cross-entropy, full backward; accumulate ``grad(w) ** 2 . mean(0)`` per
dense linear (a per-input-channel vector); finally ``sqrt(sum / n)``.

The differentiated weights are the JAX package's: every dense ``w`` that
``iter_linears`` yields (low-rank leaves are skipped). A tied head's weight
IS the embedding matrix, so the one tensor that the lookup and the head both
use is differentiated under the name ``lm_head`` and autograd sums both
uses' gradients into it, Gemma's embedding normalizer included.

Reduction: each differentiated weight carries a post-accumulate-grad hook
that folds its gradient into its accumulator (squared in f32 a block of
rows at a time) and drops it, so the device holds one weight's gradient at
a time, never the whole model's. That is
this package's answer to the memory problem that the JAX package's
layer-streamed backward solves for host-resident layers. Layers run under
activation checkpointing (``forward_hidden(remat=True)``).
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from asvd4llm_tpu_torch.models.decoder import apply_lm_head, forward_hidden
from asvd4llm_tpu_torch.models.registry import iter_linears

log = logging.getLogger(__name__)

# gradient rows squared in f32 at a time: squaring a whole 32000-row head
# gradient in f32 would hold two 0.5 GB copies beside it at 7B widths
ROW_CHUNK = 1024


def _differentiated_weights(params, spec, include_extras) -> dict:
    """{name: w} of every dense linear (a tied head: the embedding)."""
    return {name: leaf["w"]
            for name, leaf in iter_linears(params, spec, include_extras)
            if "w" in leaf}


def fisher_loss(params, spec, ids, double_shift=False):
    """Mean next-token NLL of a batch, f32 log-softmax, layers under remat.

    double_shift=True is the reference's exact loss: it hands labels
    already shifted by one to the HF model, which shifts them again
    (ref act_aware_utils.py:25-27), so the gradient is of a predict-2-ahead
    loss."""
    inputs = ids[:, :-1]
    labels = ids[:, 2:] if double_shift else ids[:, 1:]
    hidden, _ = forward_hidden(params, inputs, spec, remat=True)
    logits = apply_lm_head(params, spec, hidden)
    if double_shift:
        logits = logits[:, :-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None]).mean()


def calib_fisher_info(params, spec, calib_loader, cache=None,
                      cache_key: str = "", include_extras: bool = True,
                      double_shift: bool = False) -> dict:
    """{linear_name: f32 Fisher vector [in_features]} on the params' device
    (= sqrt(mean over batches of the gradient's squared row mean)). Leaves
    every weight as it found it: no ``.grad``, ``requires_grad`` False."""
    dev = params["embed_tokens"].device
    if cache is not None:
        hit = cache.load_arrays("fisher", cache_key)
        if hit is not None:
            log.info("fisher cache hit (%s)", cache_key)
            return {k: torch.as_tensor(v, device=dev) for k, v in hit.items()}

    weights = _differentiated_weights(params, spec, include_extras)
    acc = {name: torch.zeros(w.shape[1], dtype=torch.float32, device=dev)
           for name, w in weights.items()}

    def fold(name):
        def hook(w):
            g = w.grad
            sq = sum(rows.float().square().sum(0) for rows in g.split(ROW_CHUNK))
            acc[name].add_(sq / g.shape[0])
            w.grad = None
        return hook

    handles = []
    n = 0
    try:
        for name, w in weights.items():
            w.requires_grad_(True)
            handles.append(w.register_post_accumulate_grad_hook(fold(name)))
        with torch.enable_grad():
            for batch in calib_loader:
                ids = torch.as_tensor(np.asarray(batch["input_ids"]),
                                      dtype=torch.long, device=dev)
                fisher_loss(params, spec, ids, double_shift).backward()
                n += 1
    finally:
        for h in handles:
            h.remove()
        for w in weights.values():
            w.grad = None
            w.requires_grad_(False)

    fisher = {k: torch.sqrt(v / n) for k, v in acc.items()}
    if cache is not None:
        cache.save_arrays("fisher", cache_key,
                          {k: v.cpu().numpy() for k, v in fisher.items()})
    return fisher
