"""Automatic KV-cache layout selection for the paged serving engine.

Counterpart of asvd4llm_tpu/serving/layout.py. The engine serves a
KV-compressed model from one of three cache layouts — dense {k, v},
latent-V {k, tv}, fused latent-KV {tk, tv} — and reads each either through
the paged flash-decoding kernels (ops/paged_attention.py) or through the
plain gather path. The selector keeps the JAX package's decision rule so
that both packages choose alike on the same ranks:

- **latent-V** absorbs V exactly (V has no RoPE): the per-token V read
  drops from KV·hd to Rv, while the V sum contracts against Rv instead of
  hd. It is the choice at MHA once the context is long enough
  (``expected_T`` ≥ 2048), at GQA on a strong saving (Rv ≤ 0.5·KV·hd), and
  on a thin GQA saving only for short contexts (``expected_T`` ≤ 2048).
- **fused latent-KV** maximizes the cache saving but re-pays the K
  up-projection (Rk × KV·hd) against every cached position on every step;
  it is chosen only on an explicit memory preference.
- **the kernels** are used on a CUDA device when the kernel contract holds:
  RoPE positions and no k-projection bias.

The two 2048-token crossovers are the JAX package's, taken from its
measurements on another accelerator; they were not measured on the H100,
and no speed ratio of that accelerator applies here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from asvd4llm_tpu_torch.models.registry import is_lowrank


@dataclass(frozen=True)
class LayoutDecision:
    latent: object          # False | "v" | "kv"  (PagedEngine contract)
    use_pallas: bool
    cache_ratio: float      # projected KV-cache bytes vs the dense cache
    reason: str


def _rank_stats(params, key: str):
    """(n_lowrank_layers, mean rank) of `key` projections."""
    ranks = [layer[key]["A"].shape[1]
             for layer in params["layers"] if is_lowrank(layer[key])]
    return len(ranks), (sum(ranks) / len(ranks) if ranks else 0.0)


def pallas_eligible(params, spec) -> bool:
    """The paged kernels' contract: rope positions and bias-free k_proj
    (llama/gemma-family geometry; OPT's learned positions and biases take
    the gather path)."""
    if spec.pos_emb != "rope":
        return False
    return all(layer["k_proj"].get("b") is None for layer in params["layers"])


# The JAX package's context-length crossovers (not measured on the H100)
_MHA_LATENT_V_MIN_T = 2048
_GQA_THIN_LATENT_V_MAX_T = 2048


def choose_layout(params, spec, *, device=None, prefer_memory: bool = False,
                  expected_T: int | None = None) -> LayoutDecision:
    """Pick (latent mode, use_pallas) for PagedEngine from the model's
    realized ranks.

    ``device`` is where the engine runs (default: the params' device); the
    kernels are chosen only on a CUDA device. ``expected_T`` is the expected
    decode context in tokens — the engine passes ``max_pages_per_seq *
    page_size``, its per-sequence bound. None keeps the T-independent
    choices. prefer_memory=True takes the maximal fused latent-KV saving."""
    device = torch.device(device) if device is not None \
        else params["embed_tokens"].device
    KV_hd = spec.kv_dim
    n_v, rv = _rank_stats(params, "v_proj")
    n_k, rk = _rank_stats(params, "k_proj")
    L = len(params["layers"])
    up = device.type == "cuda" and pallas_eligible(params, spec)
    rep = max(1, spec.num_heads // max(1, spec.num_kv_heads))

    # a saving exists when the rank-dim latent is narrower than the
    # head-space row it replaces; the default also needs the context rule
    v_saves_any = n_v > 0 and rv < 0.95 * KV_hd
    k_saves = n_k > 0 and rk < 0.95 * KV_hd
    if rep == 1:
        v_saves = v_saves_any and (expected_T is None
                                   or expected_T >= _MHA_LATENT_V_MIN_T)
    elif rv <= 0.5 * KV_hd:
        v_saves = v_saves_any
    else:
        v_saves = v_saves_any and (expected_T is not None
                                   and expected_T <= _GQA_THIN_LATENT_V_MAX_T)

    if prefer_memory and v_saves_any and k_saves:
        # mean over layers; dense layers cache dense rows
        ratio = (sum((layer["k_proj"]["A"].shape[1]
                      + layer["v_proj"]["A"].shape[1])
                     if is_lowrank(layer["k_proj"])
                     and is_lowrank(layer["v_proj"]) else 2 * KV_hd
                     for layer in params["layers"]) / (2 * KV_hd * L))
        return LayoutDecision(
            "kv", up, ratio,
            f"fused latent-KV on explicit memory preference: {ratio:.2f}x "
            "the dense cache, at the cost of the K up-projection over every "
            "cached position on every step")
    if v_saves:
        ratio = (sum((KV_hd + layer["v_proj"]["A"].shape[1])
                     if is_lowrank(layer["v_proj"]) else 2 * KV_hd
                     for layer in params["layers"]) / (2 * KV_hd * L))
        return LayoutDecision(
            "v", up, ratio,
            f"latent-V: {ratio:.2f}x the dense cache (V absorbs exactly, no "
            "RoPE)")
    if v_saves_any:
        why = (f"dense cache: MHA latent-V needs expected_T >= "
               f"{_MHA_LATENT_V_MIN_T} and expected_T is {expected_T}"
               if rep == 1 else
               f"dense cache: GQA with a thin V rank saving (Rv {rv:.0f} > "
               f"0.5*{KV_hd}) needs expected_T <= {_GQA_THIN_LATENT_V_MAX_T} "
               f"and expected_T is {expected_T}")
    else:
        why = "dense cache: no v_proj rank saving to realize"
    return LayoutDecision(
        False, up, 1.0,
        why + ("" if up else "; gather path (kernel contract unmet or not a "
                             "CUDA device)"))
