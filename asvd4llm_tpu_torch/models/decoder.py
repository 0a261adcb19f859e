"""One functional decoder covering the OPT / Llama / Mistral / Qwen2 /
Gemma / Gemma-2 families.

A plain function of (params dict, input_ids, spec), the counterpart of
asvd4llm_tpu/models/decoder.py with the same casts:

- norms compute in f32 and round once to the activation dtype;
- linears accumulate in f32 and round once (ops/lowrank.py);
- attention logits and softmax are f32, probabilities are rounded to V's
  dtype before the weighted sum, which accumulates in f32;
- GQA contracts grouped query heads [B, S, KV, rep, hd] against the raw
  K/V (HF repeat_interleave head order), never materializing repeated K/V.

Statistics collection (the reference's forward hooks) is an optional
``stats`` dict filled by the same forward (``forward_with_stats``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from asvd4llm_tpu_torch.models.registry import (
    is_lowrank, is_q4_lowrank, is_q8_lowrank, linear_name,
)
from asvd4llm_tpu_torch.ops.lowrank import dense_apply, lowrank_apply

NEG = -1e30


# ---------------------------------------------------------------- norms ---

def rms_norm(x, w, eps, unit_offset=False):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if unit_offset else w.float()
    return (xf * scale).to(x.dtype)


def layer_norm(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * w.float() + b.float()).to(x.dtype)


def apply_norm(spec, norm_params, x):
    if spec.norm == "rmsnorm":
        return rms_norm(x, norm_params["w"], spec.norm_eps,
                        unit_offset=spec.rmsnorm_unit_offset)
    return layer_norm(x, norm_params["w"], norm_params["b"], spec.norm_eps)


# ----------------------------------------------------------------- rope ---

def rope_cos_sin(positions, head_dim, theta):
    """positions: [S] int -> f32 cos/sin [S, head_dim] ('rotate half')."""
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=dev) / head_dim))
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x, cos, sin):
    """x: [B, S, H, hd]; cos/sin: [S, hd] f32."""
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return (x.float() * c + rotate_half(x).float() * s).to(x.dtype)


# -------------------------------------------------------------- linears ---

def _accumulate_stats(stats, name, x, collect):
    """Input statistics of one linear (ref act_aware_utils.py:64-74)."""
    absx = x.float().abs()
    flat = absx.reshape(-1, absx.shape[-1]) if absx.dim() == 2 else absx
    prev = stats.get(name)
    if collect == "abs_mean":
        # per-batch-entry mean over seq, summed over entries (ref :65-67)
        contrib = flat.mean(dim=-2)
        contrib = contrib.sum(dim=0) if contrib.dim() == 2 else contrib
        stats[name] = contrib if prev is None else prev + contrib
    elif collect == "abs_max":
        contrib = flat.reshape(-1, flat.shape[-1]).amax(dim=0)
        stats[name] = contrib if prev is None else torch.maximum(prev, contrib)
    else:
        raise ValueError(f"unknown stats method {collect!r}")


def apply_linear(leaf, x, *, name=None, stats=None, collect=None,
                 use_pallas=False):
    """Apply a dense, low-rank or quantized low-rank linear leaf; optionally
    accumulate calibration statistics of its INPUT (ref
    act_aware_utils.py:64-74)."""
    if stats is not None and collect is not None and name is not None:
        _accumulate_stats(stats, name, x, collect)
    if is_q4_lowrank(leaf) or is_q8_lowrank(leaf):
        return _apply_quantized(leaf, x, use_pallas)
    if is_lowrank(leaf):
        return lowrank_apply(x, leaf["A"], leaf["B"], leaf["b"],
                             use_pallas=use_pallas)
    return dense_apply(x, leaf["w"], leaf["b"])


def _apply_quantized(leaf, x, use_pallas):
    """A q8 or q4 deployment leaf: the fused quantized kernels with
    ``use_pallas`` (the JAX package always takes them), else dequantize +
    two plain matmuls (what the JAX package runs off the accelerator)."""
    from asvd4llm_tpu_torch.ops.fused_lowrank import MAX_FUSED_TOKENS
    from asvd4llm_tpu_torch.ops.fused_lowrank_q import (
        fused_lowrank_apply_q4, fused_lowrank_apply_q8,
    )
    from asvd4llm_tpu_torch.ops.quant import QuantParams

    max_tokens = MAX_FUSED_TOKENS if use_pallas else 0
    if is_q4_lowrank(leaf):
        group = leaf["B4"].shape[1] * 2 // leaf["Bsc"].shape[1]
        return fused_lowrank_apply_q4(x, leaf["A4"], leaf["Asc"], leaf["Azs"],
                                      leaf["B4"], leaf["Bsc"], leaf["Bzs"],
                                      leaf["b"], group=group,
                                      max_tokens=max_tokens)
    return fused_lowrank_apply_q8(x, leaf["A8"], QuantParams(leaf["Asc"], leaf["Azp"], 255),
                                  leaf["B8"], QuantParams(leaf["Bsc"], leaf["Bzp"], 255),
                                  leaf["b"], max_tokens=max_tokens)


def activation(spec, x):
    if spec.act == "silu":
        return F.silu(x)
    if spec.act == "relu":
        return F.relu(x)
    if spec.act == "gelu":
        return F.gelu(x, approximate="none")
    if spec.act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {spec.act!r}")


def softcap(x, cap):
    return cap * torch.tanh(x / cap)


def attn_scale(spec):
    return spec.attn_scale if spec.attn_scale is not None else spec.head_dim ** -0.5


# ------------------------------------------------------------ attention ---

# long-prefill attention blocks over keys once the materialized score
# tensor would dominate memory (decoder.py:197-201 of the JAX package)
_BLOCK_MIN_SQ = 2049
_BLOCK_SIZE = 512


def _attention(spec, layer, x, cos, sin, mask, *, la, cache=None,
               cache_pos=0):
    """Multi-head attention with GQA, RoPE/none, optional logit softcap and
    optional dense KV cache. Returns (output, new cache entry). A cache is
    written in place at [cache_pos, cache_pos + S)."""
    B, S, _ = x.shape
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim

    q = la("q_proj", x).reshape(B, S, H, hd)
    k = la("k_proj", x).reshape(B, S, KV, hd)
    v = la("v_proj", x).reshape(B, S, KV, hd)

    if spec.pos_emb == "rope":
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_entry = None
    if cache is not None:
        k_cache, v_cache = cache  # [B, T, KV, hd]
        k_cache[:, cache_pos:cache_pos + S] = k.to(k_cache.dtype)
        v_cache[:, cache_pos:cache_pos + S] = v.to(v_cache.dtype)
        k, v = k_cache, v_cache
        new_entry = (k_cache, v_cache)

    rep = H // KV
    scale = attn_scale(spec)
    qg = q.reshape(B, S, KV, rep, hd)
    Sk = k.shape[1]
    if S >= _BLOCK_MIN_SQ and Sk >= 2 * _BLOCK_SIZE:
        out = _attention_blocked(spec, qg, k, v, mask, scale)
    else:
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * scale
        if spec.attn_logit_softcap > 0:
            logits = softcap(logits, spec.attn_logit_softcap)
        logits = logits + mask[:, :, None]  # mask: [1|B, 1, Sq, Sk]
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v).to(x.dtype)
        out = out.reshape(B, S, H * hd)
    o_key = "o_proj" if "o_proj" in layer else "out_proj"
    return la(o_key, out), new_entry


def _attention_blocked(spec, qg, k, v, mask, scale):
    """Blocked attention over key blocks with a running (max, denominator,
    accumulator) online softmax: O(Sq * block) scores instead of O(Sq * Sk).
    Same math as the JAX package's lax.scan version."""
    B, S, KV, rep, hd = qg.shape
    Sk = k.shape[1]
    C = _BLOCK_SIZE
    mask = mask.expand(mask.shape[0], 1, S, Sk)
    qf = qg.float()
    m = torch.full((B, KV, rep, S), NEG, dtype=torch.float32, device=qg.device)
    den = torch.zeros((B, KV, rep, S), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, KV, rep, S, hd), dtype=torch.float32, device=qg.device)
    for c0 in range(0, Sk, C):
        kb, vb = k[:, c0:c0 + C], v[:, c0:c0 + C]
        logits = torch.einsum("bqgrd,bcgd->bgrqc", qf, kb.float()) * scale
        if spec.attn_logit_softcap > 0:
            logits = softcap(logits, spec.attn_logit_softcap)
        logits = logits + mask[:, :, None, :, c0:c0 + C]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        den = den * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqc,bcgd->bgrqd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = (acc / den[..., None]).to(qg.dtype)          # [B, g, r, S, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, KV * rep * hd)


def causal_mask(spec, layer_idx, q_pos, k_pos, pad_mask=None):
    """Additive f32 mask [1|B, 1, Sq, Sk]: causal, optional sliding window,
    optional padding mask [B, Sk]."""
    allow = k_pos[None, :] <= q_pos[:, None]
    if spec.layer_uses_sliding(layer_idx):
        allow &= k_pos[None, :] > (q_pos[:, None] - spec.sliding_window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    neg = torch.full((), NEG, dtype=torch.float32, device=q_pos.device)
    m = torch.where(allow, zero, neg)[None, None, :, :]
    if pad_mask is not None:
        pm = torch.where(pad_mask.bool(), zero, neg)[:, None, None, :]
        m = m + pm
    return m


# ------------------------------------------------------------- layers ----

def decoder_layer(spec, layer, x, cos, sin, mask, *, la, cache=None,
                  cache_pos=0):
    if spec.family == "opt":
        return _opt_layer(spec, layer, x, cos, sin, mask, la=la,
                          cache=cache, cache_pos=cache_pos)

    residual = x
    h = apply_norm(spec, layer["ln1"], x)
    attn_out, new_entry = _attention(spec, layer, h, cos, sin, mask, la=la,
                                     cache=cache, cache_pos=cache_pos)
    if spec.post_attn_out_norm:  # gemma2
        attn_out = apply_norm(spec, layer["ln1_post"], attn_out)
    x = residual + attn_out

    residual = x
    h = apply_norm(spec, layer["ln2"], x)
    if spec.mlp == "gated":
        gate = activation(spec, la("gate_proj", h))
        up = la("up_proj", h)
        mlp_out = la("down_proj", gate * up)
    else:
        mlp_out = la("fc2", activation(spec, la("fc1", h)))
    if spec.post_mlp_out_norm:  # gemma2
        mlp_out = apply_norm(spec, layer["ln2_post"], mlp_out)
    return residual + mlp_out, new_entry


def _opt_layer(spec, layer, x, cos, sin, mask, *, la, cache=None,
               cache_pos=0):
    """OPT decoder layer (pre-norm when do_layer_norm_before, else post)."""
    residual = x
    h = apply_norm(spec, layer["ln1"], x) if spec.do_layer_norm_before else x
    attn_out, new_entry = _attention(spec, layer, h, cos, sin, mask, la=la,
                                     cache=cache, cache_pos=cache_pos)
    x = residual + attn_out
    if not spec.do_layer_norm_before:
        x = apply_norm(spec, layer["ln1"], x)

    residual = x
    h = apply_norm(spec, layer["ln2"], x) if spec.do_layer_norm_before else x
    h = la("fc2", activation(spec, la("fc1", h)))
    x = residual + h
    if not spec.do_layer_norm_before:
        x = apply_norm(spec, layer["ln2"], x)
    return x, new_entry


def layer_applier(spec, layer, layer_idx, *, stats=None, collect=None,
                  use_pallas=False):
    """``la(key, h)``: apply the layer's linear ``key`` to h, naming it for
    statistics collection."""
    def la(key, h):
        name = linear_name(spec, layer_idx, key) if stats is not None else None
        return apply_linear(layer[key], h, name=name, stats=stats,
                            collect=collect, use_pallas=use_pallas)
    return la


# ------------------------------------------------------------- forward ---

def embed(params, spec, input_ids, *, stats=None, collect=None,
          use_pallas=False):
    """Token embedding (+ Gemma's normalizer, + OPT-350m's project_in)."""
    x = F.embedding(input_ids, params["embed_tokens"])
    if spec.embed_scale != 1.0:
        # gemma rounds the normalizer to the embedding dtype first
        x = x * torch.tensor(spec.embed_scale, dtype=x.dtype, device=x.device)
    if params.get("project_in") is not None:
        x = apply_linear(params["project_in"], x,
                         name="model.decoder.project_in",
                         stats=stats, collect=collect, use_pallas=use_pallas)
    return x


def final_hidden(params, spec, x, *, stats=None, collect=None,
                 use_pallas=False):
    """Final norm (+ OPT-350m's project_out)."""
    if spec.final_norm and params.get("final_norm") is not None:
        x = apply_norm(spec, params["final_norm"], x)
    if params.get("project_out") is not None:
        x = apply_linear(params["project_out"], x,
                         name="model.decoder.project_out",
                         stats=stats, collect=collect, use_pallas=use_pallas)
    return x


def forward_hidden(params, input_ids, spec, *, positions=None, pad_mask=None,
                   stats=None, collect=None, use_pallas=False, caches=None,
                   cache_pos=0, remat=False):
    """Embeddings + all decoder layers + final norm -> hidden [B, S, hidden]
    (= reference's ``lm.model.model(batch)``, evaluate_utils.py:163).

    caches: optional list of per-layer (k_cache, v_cache), written in place;
    returns (hidden, caches).

    remat: run each layer under non-reentrant activation checkpointing, so
    a backward recomputes a layer's activations instead of keeping them (the
    JAX flag's ``jax.checkpoint``). The non-reentrant form passes gradients
    to the weights a layer closes over even when its input hidden state
    needs none. Not with ``caches`` (written in place) or ``stats`` (a
    recompute would count them twice)."""
    if remat and (caches is not None or stats is not None):
        raise ValueError("remat runs without caches and without statistics")
    B, S = input_ids.shape
    dev = input_ids.device
    x = embed(params, spec, input_ids, stats=stats, collect=collect,
              use_pallas=use_pallas)

    if positions is None:
        positions = torch.arange(S, device=dev) + cache_pos
    if spec.pos_emb == "learned":
        x = x + params["embed_positions"][positions + spec.pos_offset]
        cos = sin = None
    else:
        cos, sin = rope_cos_sin(positions, spec.head_dim, spec.rope_theta)

    kv_len = caches[0][0].shape[1] if caches is not None else S
    k_pos = torch.arange(kv_len, device=dev)

    new_caches = [] if caches is not None else None
    for i, layer in enumerate(params["layers"]):
        mask = causal_mask(spec, i, positions, k_pos, pad_mask)
        la = layer_applier(spec, layer, i, stats=stats, collect=collect,
                           use_pallas=use_pallas)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda h, la=la, layer=layer, mask=mask: decoder_layer(
                    spec, layer, h, cos, sin, mask, la=la)[0],
                x, use_reentrant=False)
            continue
        x, entry = decoder_layer(spec, layer, x, cos, sin, mask, la=la,
                                 cache=None if caches is None else caches[i],
                                 cache_pos=cache_pos)
        if new_caches is not None:
            new_caches.append(entry)

    x = final_hidden(params, spec, x, stats=stats, collect=collect,
                     use_pallas=use_pallas)
    return x, new_caches


def apply_lm_head(params, spec, hidden, *, stats=None, collect=None,
                  use_pallas=False):
    """hidden [B, S, H] -> logits [B, S, V] float32
    (= reference's ``lm.model.lm_head(hidden)``, evaluate_utils.py:167).
    An explicit lm_head leaf always wins over the tied embedding."""
    if params.get("lm_head") is not None:
        logits = apply_linear(params["lm_head"], hidden, name="lm_head",
                              stats=stats, collect=collect,
                              use_pallas=use_pallas).float()
    else:
        if stats is not None and collect is not None:
            # tied head: the reference's hook still fires on lm_head input
            _accumulate_stats(stats, "lm_head", hidden, collect)
        logits = torch.matmul(hidden.float(), params["embed_tokens"].float().t())
    if spec.final_logit_softcap > 0:
        logits = softcap(logits, spec.final_logit_softcap)
    return logits


def forward(params, input_ids, spec, *, positions=None, pad_mask=None,
            use_pallas=False, caches=None, cache_pos=0):
    """Full forward -> logits [B, S, vocab] float32."""
    hidden, new_caches = forward_hidden(
        params, input_ids, spec, positions=positions, pad_mask=pad_mask,
        use_pallas=use_pallas, caches=caches, cache_pos=cache_pos)
    logits = apply_lm_head(params, spec, hidden, use_pallas=use_pallas)
    if caches is not None:
        return logits, new_caches
    return logits


def forward_with_stats(params, input_ids, spec, *, collect="abs_mean",
                       pad_mask=None):
    """Forward that also returns per-linear input statistics
    {full_name: [in_features] f32} (ref act_aware_utils.py:62-81)."""
    stats: dict = {}
    hidden, _ = forward_hidden(params, input_ids, spec, pad_mask=pad_mask,
                               stats=stats, collect=collect)
    logits = apply_lm_head(params, spec, hidden, stats=stats, collect=collect)
    return logits, stats
