"""The prefix-resumable decoder forward of the sensitivity scan.

Counterpart of the parts of asvd4llm_tpu/models/scan_forward.py that the
scan uses: ``can_scan`` (:35), ``embed_scan_inputs`` (:211),
``_finish_hidden`` (:250), ``forward_hidden_scan_from`` (:355) and
``apply_stacked_layer`` (:392).

The JAX module stacks the decoder's weights into [L, ...] arrays and drives
one ``lax.scan``, so that XLA compiles one layer body whatever the depth;
a traced ``lax.cond`` skips the prefix and a traced ``where`` substitutes
the candidate weight. PyTorch compiles nothing, so here the functions loop
over the per-layer leaves with the decoder's own layer function
(``models/decoder.py::decoder_layer``, the Gemma-2 sliding/global mask
chosen per layer as the decoder chooses it), start at the first layer they
run, and substitute by swapping one leaf. No stacked copy of the weights
is made: at Llama-2-7B it would only duplicate 13.5 GB. Where a JAX
signature takes ``stacked``, these take the params. ``forward_stats_scan``
and ``forward_scan`` are not ported: ``calib/stats.py`` and ``eval/ppl.py``
give the same numbers.
"""

from __future__ import annotations

import torch

from asvd4llm_tpu_torch.models.decoder import (
    causal_mask, decoder_layer, embed, final_hidden, layer_applier,
    rope_cos_sin,
)
from asvd4llm_tpu_torch.models.registry import (
    dense_leaf, is_lowrank, is_q4_lowrank, is_q8_lowrank, layer_linear_keys,
)


def _factored(leaf: dict) -> bool:
    return is_lowrank(leaf) or is_q8_lowrank(leaf) or is_q4_lowrank(leaf)


def can_scan(params: dict, spec) -> bool:
    """True iff every decoder layer is all-dense with identical structure
    (bias presence and weight shape per key), and OPT's projections are
    dense. Unlike the JAX version (:48, :52, which tests only int8 leaves)
    an int4 leaf also answers False."""
    layers = params["layers"]
    if not layers:
        return False
    for pk in ("project_in", "project_out"):
        leaf = params.get(pk)
        if leaf is not None and _factored(leaf):
            return False
    keys = layer_linear_keys(spec)
    ref = layers[0]
    for layer in layers:
        for k in keys:
            leaf = layer[k]
            if _factored(leaf):
                return False
            if (leaf["b"] is None) != (ref[k]["b"] is None):
                return False
            if leaf["w"].shape != ref[k]["w"].shape:
                return False
    return True


def _rope(spec, S, device):
    if spec.pos_emb == "learned":
        return None, None
    return rope_cos_sin(torch.arange(S, device=device), spec.head_dim,
                        spec.rope_theta)


def embed_scan_inputs(params, input_ids, spec):
    """Embeddings (+ embed scale, OPT project_in, learned positions): the
    layer-0 input hidden states, and the rope tables."""
    S = input_ids.shape[1]
    x = embed(params, spec, input_ids)
    if spec.pos_emb == "learned":
        positions = torch.arange(S, device=input_ids.device)
        x = x + params["embed_positions"][positions + spec.pos_offset]
    cos, sin = _rope(spec, S, input_ids.device)
    return x, cos, sin


# final norm + OPT project_out: the decoder's own
_finish_hidden = final_hidden


def _run_layer(params, spec, i, x, cos, sin, positions, pad_mask,
               substitute=None):
    layer = params["layers"][i]
    if substitute is not None and substitute[1] == i:
        key, _, w_hat = substitute
        layer = {**layer, key: dense_leaf(w_hat.to(layer[key]["w"].dtype),
                                          layer[key]["b"])}
    mask = causal_mask(spec, i, positions, positions, pad_mask)
    x, _ = decoder_layer(spec, layer, x, cos, sin, mask,
                         la=layer_applier(spec, layer, i))
    return x


def forward_hidden_scan_from(params, hidden, spec, *, start: int,
                             substitute=None, pad_mask=None):
    """Run layers ``start``..L-1 from the cached hidden states ``hidden``
    [B, S, H] (embeddings and layers < start already applied), then the
    final norm. ``substitute`` = (leaf_key, target, w_hat) replaces layer
    ``target``'s dense weight ``leaf_key`` with ``w_hat``: a candidate at
    layer l pays only the l..L-1 suffix."""
    S = hidden.shape[1]
    positions = torch.arange(S, device=hidden.device)
    cos, sin = _rope(spec, S, hidden.device)
    x = hidden
    for i in range(int(start), len(params["layers"])):
        x = _run_layer(params, spec, i, x, cos, sin, positions, pad_mask,
                       substitute)
    return _finish_hidden(params, spec, x)


def apply_stacked_layer(params, hidden, spec, *, idx: int, pad_mask=None):
    """Apply decoder layer ``idx`` to hidden [B, S, H]: after layer l's
    grid is scored, one call advances the cached dense hidden from layer
    l's input to layer l+1's."""
    S = hidden.shape[1]
    positions = torch.arange(S, device=hidden.device)
    cos, sin = _rope(spec, S, hidden.device)
    return _run_layer(params, spec, int(idx), hidden, cos, sin, positions,
                      pad_mask)
