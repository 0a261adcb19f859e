"""Perplexity evaluators with the reference's loss semantics.

Counterpart of asvd4llm_tpu/eval/ppl.py:

1. ``evaluate_perplexity`` (ref evaluate_utils.py:90-115), the calibration
   PPL of the sensitivity scan and the ppl-target search: per row of an
   [n, seqlen] id matrix, input = row[:-1], labels = row[1:],
   nll = mean-CE * seqlen (the reference's own off-by-one, kept);
   ppl = exp(sum nll / (n * seqlen)) = exp(mean of the row means).

2. ``evaluate_ppl_windowed`` (ref evaluate_utils.py:140-191), the final
   metric: non-overlapping seqlen windows over one token stream, shift-by-
   one CE over seqlen-1 positions; the BOS mode shrinks the window to
   seqlen-1 and prepends BOS (ref :151,160-166).

Rows and windows are batched, which is exact: both statistics are means of
per-row means.
"""

from __future__ import annotations

import numpy as np
import torch

from asvd4llm_tpu_torch.models.decoder import apply_lm_head, forward_hidden


def _device_of(params) -> torch.device:
    return params["embed_tokens"].device


def _rows_nll(params, spec, rows, use_pallas=False):
    """Mean next-token CE of each row of [B, L] -> [B] f32."""
    hidden, _ = forward_hidden(params, rows[:, :-1], spec, use_pallas=use_pallas)
    logits = apply_lm_head(params, spec, hidden, use_pallas=use_pallas)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, rows[:, 1:, None])[..., 0].mean(dim=-1)


@torch.no_grad()
def evaluate_perplexity(params, spec, dataset, limit: int = -1,
                        row_batch: int = 4) -> float:
    """dataset: [n, seqlen] int ids. limit: evaluate the first `limit` rows
    (ref evaluate_utils.py:100-101)."""
    ids = torch.as_tensor(np.asarray(dataset), device=_device_of(params))
    if limit is not None and 0 < limit < ids.shape[0]:
        ids = ids[:limit]
    # long rows shrink the batch so the attention-score transient stays
    # bounded at seqlen 2048
    rb = min(row_batch, max(1, 4096 // ids.shape[1]), ids.shape[0])
    total = torch.zeros((), dtype=torch.float32, device=ids.device)
    for i in range(0, ids.shape[0], rb):
        total = total + _rows_nll(params, spec, ids[i:i + rb]).sum()
    return float(torch.exp(total / ids.shape[0]))


def _window_nll(params, spec, window, use_bos, bos_token_id, use_pallas):
    """[B, seqlen] windows -> per-window mean CE over the seqlen-1 shifted
    positions (ref evaluate_utils.py:158-176)."""
    batch = window
    if use_bos:
        bos = torch.full((batch.shape[0], 1), bos_token_id, dtype=batch.dtype,
                         device=batch.device)
        batch = torch.cat([bos, batch], dim=1)
    hidden, _ = forward_hidden(params, batch, spec, use_pallas=use_pallas)
    if use_bos:
        hidden = hidden[:, 1:, :]
    logits = apply_lm_head(params, spec, hidden, use_pallas=use_pallas)
    logp = torch.log_softmax(logits[:, :-1, :].float(), dim=-1)
    return -torch.gather(logp, -1, window[:, 1:, None])[..., 0].mean(dim=-1)


@torch.no_grad()
def evaluate_ppl_windowed(params, spec, token_stream, seqlen: int = 2048,
                          *, use_bos: bool = False, bos_token_id: int = 0,
                          limit: int = -1, use_pallas: bool = False) -> float:
    """token_stream: [1, N] or [N] concatenated eval tokens. The reference's
    windowing: N // seqlen non-overlapping windows; with use_bos the window
    shrinks by 1 (ref evaluate_utils.py:151-152)."""
    toks = np.asarray(token_stream).reshape(-1)
    if use_bos:
        seqlen = seqlen - 1
    nsamples = len(toks) // seqlen
    if limit is not None and 0 < limit + 1 < nsamples:
        # ref breaks AFTER evaluating window i == limit (ref :177-178)
        nsamples = limit + 1
    dev = _device_of(params)
    wb = 4
    total = 0.0
    for i in range(0, nsamples, wb):
        b = min(wb, nsamples - i)
        rows = torch.as_tensor(toks[i * seqlen:(i + b) * seqlen].reshape(b, seqlen),
                               device=dev)
        total += float(_window_nll(params, spec, rows, use_bos, bos_token_id,
                                   use_pallas).sum())
    # ref: exp(sum(loss*seqlen) / (n*seqlen)) == exp(mean(loss))
    return float(np.exp(total / max(nsamples, 1)))
