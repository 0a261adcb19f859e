"""Greedy generation with dense or low-rank-latent KV caches.

Counterpart of asvd4llm_tpu/eval/generate.py. For a layer whose k/v
projections are low-rank, the ``"kv"`` cache holds the rank-dim latents
``t = x @ B.T`` instead of K and V:

- V is absorbed: the attention-weighted sum runs over the V latents and
  A_v applies to the small result (O(H*hd*Rv) per step, independent of T);
- K latents are up-projected to head space before RoPE every step (RoPE
  does not commute with the up-projection).

With ``use_pallas`` (the JAX package's name for "run the fused kernels") a
decode step sends every low-rank linear through ops/fused_lowrank.py,
every int8 or int4 deployment leaf through ops/fused_lowrank_q.py and
every ``"kv"`` latent layer with RoPE and no k bias through
ops/latent_attention.py: hand-written CUDA on a CUDA tensor, their plain
versions on the CPU. A quantized k/v leaf has no ``"A"`` factor, so its
layer keeps a dense cache, as in the JAX package.

Caches are updated in place (the JAX package returns new arrays): a
decode step writes one position of each layer's cache and returns the same
dicts.

A decode step takes its position as an int or as a 0-d int32 tensor on the
params' device and never reads it on the host (RoPE rows by
``index_select``, cache writes by ``index_copy_``, the mask from
``k_pos <= pos``), so one step captured into a CUDA graph replays at each
new position. ``generate_on_device`` decodes that way (``DecodeGraph``,
the counterpart of the JAX package's ``_decode_while``); ``generate`` is
the host loop of eager steps, and ``generate_auto`` picks the first on a
CUDA device, as the JAX package picks its while-loop on a TPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from asvd4llm_tpu_torch.models.decoder import (
    activation, apply_linear, apply_lm_head, apply_norm, apply_rope, attn_scale,
    causal_mask, embed, final_hidden, forward_hidden, layer_applier,
    rope_cos_sin,
)
from asvd4llm_tpu_torch.models.registry import is_lowrank
from asvd4llm_tpu_torch.ops.latent_attention import device_position, latent_decode_attention
from asvd4llm_tpu_torch.ops.lowrank import align_ranks
from asvd4llm_tpu_torch.utils.graphs import StepGraph

NEG = -1e30
# replays of the decode graph between two reads of the finished flags
READBACK_EVERY = 8


def layer_uses_latent_kv(layer) -> bool:
    return is_lowrank(layer["k_proj"]) and is_lowrank(layer["v_proj"])


def layer_uses_latent_v(layer) -> bool:
    return is_lowrank(layer["v_proj"])


def _cache_len(cache) -> int:
    return (cache["tk"] if "tk" in cache else cache["k"]).shape[1]


def init_caches(params, spec, batch: int, max_len: int, dtype=torch.bfloat16,
                *, latent=False, device=None) -> list:
    """Per-layer cache dicts.

    latent=False: dense {"k","v"} [B,T,KV,hd].
    latent=True / "kv": {"tk","tv"} rank-dim latents for layers whose k AND
      v are low-rank.
    latent="v": dense K + latent V {"k","tv"} for layers whose v is
      low-rank."""
    device = device or params["embed_tokens"].device
    kv_heads = spec.kv_dim // spec.head_dim
    mode = latent if isinstance(latent, str) else ("kv" if latent else "")

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    caches = []
    for layer in params["layers"]:
        if mode == "kv" and layer_uses_latent_kv(layer):
            caches.append({
                "tk": zeros(batch, max_len, layer["k_proj"]["A"].shape[1]),
                "tv": zeros(batch, max_len, layer["v_proj"]["A"].shape[1]),
            })
        elif mode == "v" and layer_uses_latent_v(layer):
            caches.append({
                "k": zeros(batch, max_len, kv_heads, spec.head_dim),
                "tv": zeros(batch, max_len, layer["v_proj"]["A"].shape[1]),
            })
        else:
            caches.append({
                "k": zeros(batch, max_len, kv_heads, spec.head_dim),
                "v": zeros(batch, max_len, kv_heads, spec.head_dim),
            })
    return caches


def _apply_leaf(leaf, x, up=False):
    return apply_linear(leaf, x, use_pallas=up)


def _latent(leaf, x):
    """Rank-dim latent t = x @ B.T (the cacheable quantity)."""
    return F.linear(x, leaf["B"])


def _up_k(leaf, t, B, T, KV, hd):
    """Latents [B,T,Rk] -> K heads [B,T,KV,hd] via A_k (+ bias)."""
    k = torch.matmul(t.float(), leaf["A"].float().t())
    if leaf["b"] is not None:
        k = k + leaf["b"].float()
    return k.to(t.dtype).reshape(B, T, KV, hd)


def _gqa_probs(q0, k, rep, scale, cap, mask_t):
    """Grouped-query attention probabilities without materializing repeated
    K: query heads reshape to [B, KV, rep, hd] (HF repeat_interleave order)
    against the raw [B, T, KV, hd] cache. mask_t: [T] shared or [B, T] per
    sequence (ragged paged decode). -> [B, KV, rep, T] f32."""
    B, H, hd = q0.shape
    KV = k.shape[2]
    qg = q0.reshape(B, KV, rep, hd)
    logits = torch.einsum("bgrd,bkgd->bgrk", qg.float(), k.float()) * scale
    if cap > 0:
        logits = cap * torch.tanh(logits / cap)
    mask = mask_t if mask_t.dim() == 1 else mask_t[:, None, None, :]
    return torch.softmax(logits + mask, dim=-1)


def _absorbed_v_out(probs, tv, v_leaf, KV, hd, rep, x_dtype):
    """Attention-weighted sum over the Rv-dim latents, then the per-group V
    up-projection of the result. probs: [B, KV, rep, T]."""
    B, _, _, T = probs.shape
    pf = probs.reshape(B, KV * rep, T).to(tv.dtype)
    s = torch.bmm(pf.float(), tv.float())                 # [B, H, Rv]
    s = s.reshape(B, KV, rep, -1)
    a_v = v_leaf["A"].reshape(KV, hd, -1)                 # [KV, hd, Rv]
    out = torch.einsum("bgrv,gdv->bgrd", s.to(a_v.dtype).float(), a_v.float())
    if v_leaf["b"] is not None:
        # bias contributes sum(probs) * b = 1 * b after softmax
        out = out + v_leaf["b"].float().reshape(KV, hd)[None, :, None, :]
    return out.to(x_dtype).reshape(B, 1, KV * rep * hd)


def _attend_step(spec, layer, x, cache, pos, cos_full, sin_full, layer_idx,
                 up=False):
    """One-token attention (x: [B,1,hidden]) against the cache, which is
    written in place at ``pos`` (an int or a 0-d int32 tensor); returns
    (attn_out, cache)."""
    B = x.shape[0]
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    T = _cache_len(cache)
    rep = H // KV
    o_key = "o_proj" if "o_proj" in layer else "out_proj"
    pos = device_position(pos, T, x.device)
    idx = pos.reshape(1).long()

    def write(key, val):  # val [B, 1, ...] into position pos of the cache
        cache[key].index_copy_(1, idx, val.to(cache[key].dtype))

    q = _apply_leaf(layer["q_proj"], x, up).reshape(B, 1, H, hd)
    cos_q, sin_q = cos_full.index_select(0, idx), sin_full.index_select(0, idx)
    if spec.pos_emb == "rope":
        q = apply_rope(q, cos_q, sin_q)

    scale = attn_scale(spec)
    sliding = spec.sliding_window if spec.layer_uses_sliding(layer_idx) else 0
    k_pos = torch.arange(T, device=x.device)
    allow = k_pos <= pos
    if sliding:
        allow &= k_pos > pos - sliding
    mask_t = torch.where(allow, 0.0, NEG).float()          # [T]

    if "tk" in cache:  # --- latent low-rank path ---
        write("tk", _latent(layer["k_proj"], x))
        write("tv", _latent(layer["v_proj"], x))
        tk, tv = cache["tk"], cache["tv"]

        if up and spec.pos_emb == "rope" and layer["k_proj"]["b"] is None:
            # fused flash-decoding over the latents: K is never written
            # to device memory
            out = latent_decode_attention(
                q[:, 0], tk, tv, layer["k_proj"]["A"], layer["v_proj"]["A"],
                cos_full, sin_full, pos, kv_heads=KV, scale=scale,
                softcap=spec.attn_logit_softcap, sliding=sliding,
                v_bias=layer["v_proj"]["b"])
            out = out.to(x.dtype)[:, None, :]
            return _apply_leaf(layer[o_key], out, up), cache

        k = _up_k(layer["k_proj"], tk, B, T, KV, hd)
        if spec.pos_emb == "rope":
            k = apply_rope(k, cos_full, sin_full)
        probs = _gqa_probs(q[:, 0], k, rep, scale, spec.attn_logit_softcap,
                           mask_t)
        out = _absorbed_v_out(probs, tv, layer["v_proj"], KV, hd, rep,
                              x.dtype)
    elif "tv" in cache:  # --- dense K + absorbed latent V ("v" mode) ---
        k_new = _apply_leaf(layer["k_proj"], x, up).reshape(B, 1, KV, hd)
        if spec.pos_emb == "rope":
            k_new = apply_rope(k_new, cos_q, sin_q)
        write("k", k_new)
        write("tv", _latent(layer["v_proj"], x))
        probs = _gqa_probs(q[:, 0], cache["k"], rep, scale,
                           spec.attn_logit_softcap, mask_t)
        out = _absorbed_v_out(probs, cache["tv"], layer["v_proj"], KV, hd,
                              rep, x.dtype)
    else:  # --- dense-cache path ---
        k_new = _apply_leaf(layer["k_proj"], x, up).reshape(B, 1, KV, hd)
        v_new = _apply_leaf(layer["v_proj"], x, up).reshape(B, 1, KV, hd)
        if spec.pos_emb == "rope":
            k_new = apply_rope(k_new, cos_q, sin_q)
        write("k", k_new)
        write("v", v_new)
        v = cache["v"]
        probs = _gqa_probs(q[:, 0], cache["k"], rep, scale,
                           spec.attn_logit_softcap, mask_t)
        out = torch.einsum("bgrk,bkgd->bgrd", probs.to(v.dtype), v)
        out = out.to(x.dtype).reshape(B, 1, H * hd)

    return _apply_leaf(layer[o_key], out, up), cache


def _decode_layer(spec, layer, x, cache, pos, cos_full, sin_full, layer_idx,
                  up=False, attend=None):
    """One decoder layer at decode time. ``attend`` swaps the attention and
    cache implementation (serving/paged.py passes its paged attention with
    per-sequence positions); the norm and MLP plumbing is the same for
    every cache layout."""
    attend = attend or _attend_step
    if spec.family == "opt":
        residual = x
        h = apply_norm(spec, layer["ln1"], x) if spec.do_layer_norm_before else x
        attn, cache = attend(spec, layer, h, cache, pos, cos_full,
                             sin_full, layer_idx, up=up)
        x = residual + attn
        if not spec.do_layer_norm_before:
            x = apply_norm(spec, layer["ln1"], x)
        residual = x
        h = apply_norm(spec, layer["ln2"], x) if spec.do_layer_norm_before else x
        h = _apply_leaf(layer["fc2"],
                        activation(spec, _apply_leaf(layer["fc1"], h, up)), up)
        x = residual + h
        if not spec.do_layer_norm_before:
            x = apply_norm(spec, layer["ln2"], x)
        return x, cache

    residual = x
    h = apply_norm(spec, layer["ln1"], x)
    attn, cache = attend(spec, layer, h, cache, pos, cos_full,
                         sin_full, layer_idx, up=up)
    if spec.post_attn_out_norm:
        attn = apply_norm(spec, layer["ln1_post"], attn)
    x = residual + attn
    residual = x
    h = apply_norm(spec, layer["ln2"], x)
    gate = activation(spec, _apply_leaf(layer["gate_proj"], h, up))
    upv = _apply_leaf(layer["up_proj"], h, up)
    mlp = _apply_leaf(layer["down_proj"], gate * upv, up)
    if spec.post_mlp_out_norm:
        mlp = apply_norm(spec, layer["ln2_post"], mlp)
    return residual + mlp, cache


@torch.no_grad()
def decode_step(params, spec, token, caches, pos, use_pallas=False):
    """token: [B,1] -> (logits [B,vocab] f32, caches). pos: the token's
    position, an int or a 0-d int32 tensor on the token's device (never
    read on the host, so a captured CUDA graph of this step replays at the
    tensor's current value); the caches are written in place."""
    dev = token.device
    max_len = _cache_len(caches[0])
    pos = device_position(pos, max_len, dev)
    x = embed(params, spec, token)
    if spec.pos_emb == "learned":
        row = params["embed_positions"].index_select(
            0, pos.reshape(1).long() + spec.pos_offset)
        x = x + row[None]
        cos_full = sin_full = torch.zeros((max_len, spec.head_dim), device=dev)
    else:
        cos_full, sin_full = rope_cos_sin(torch.arange(max_len, device=dev),
                                          spec.head_dim, spec.rope_theta)
    new_caches = []
    for i, layer in enumerate(params["layers"]):
        x, c = _decode_layer(spec, layer, x, caches[i], pos, cos_full,
                             sin_full, i, up=use_pallas)
        new_caches.append(c)
    x = final_hidden(params, spec, x)
    logits = apply_lm_head(params, spec, x, use_pallas=use_pallas)[:, 0]
    return logits, new_caches


@torch.no_grad()
def prefill(params, spec, ids, caches):
    """Full-sequence forward that also fills dense caches; returns
    (last-position logits [B,vocab], caches)."""
    hidden, new_caches = forward_hidden(
        params, ids, spec, caches=[(c["k"], c["v"]) for c in caches],
        cache_pos=0)
    logits = apply_lm_head(params, spec, hidden[:, -1:, :])[:, 0]
    return logits, [{"k": k, "v": v} for k, v in new_caches]


@torch.no_grad()
def prefill_host(params, spec, ids, caches, *, latent=False):
    """Prefill handling the latent layouts: latent layers get their latents
    computed directly; attention runs the normal full forward."""
    if not latent:
        return prefill(params, spec, ids, caches)
    B, S = ids.shape
    if all("tk" in c for c in caches):
        # every layer is latent-cached: ONE pass computes both the logits
        # and the latents
        logits, latents = _prefill_latents_only(params, spec, ids)
        for cache, (tk, tv) in zip(caches, latents):
            cache["tk"][:, :S] = tk.to(cache["tk"].dtype)
            cache["tv"][:, :S] = tv.to(cache["tv"].dtype)
        return logits, caches
    # mixed dense/latent layers: the dense-cache prefill for logits and
    # dense entries, then one extra pass for the latents
    ref = caches[0]["tk"] if "tk" in caches[0] else caches[0]["k"]
    dense_caches = init_caches(params, spec, B, ref.shape[1], dtype=ref.dtype,
                               latent=False, device=ref.device)
    logits, filled = prefill(params, spec, ids, dense_caches)
    latents = _attention_input_latents(params, spec, ids)
    out_caches = []
    for i, cache in enumerate(caches):
        if "tk" in cache:
            tk, tv = latents[i]
            cache["tk"][:, :S] = tk.to(cache["tk"].dtype)
            cache["tv"][:, :S] = tv.to(cache["tv"].dtype)
            out_caches.append(cache)
        elif "tv" in cache:  # dense K + latent V
            cache["tv"][:, :S] = latents[i][1].to(cache["tv"].dtype)
            out_caches.append({"k": filled[i]["k"], "tv": cache["tv"]})
        else:
            out_caches.append(filled[i])
    return logits, out_caches


def _prefill_latents_only(params, spec, ids):
    """Single-pass prefill for fully-latent models: (last-position logits,
    per-layer (tk, tv) latents)."""
    latents, hidden = _forward_capture_latents(params, spec, ids)
    logits = apply_lm_head(params, spec, hidden[:, -1:, :])[:, 0]
    return logits, latents


def _attention_input_latents(params, spec, ids):
    """Per-layer (tk, tv) latents for low-rank k/v layers over a sequence."""
    latents, _ = _forward_capture_latents(params, spec, ids)
    return latents


def _forward_capture_latents(params, spec, ids):
    """Forward pass that records each latent layer's (tk, tv) and returns
    (latents, final hidden states)."""
    x = embed(params, spec, ids)
    S = ids.shape[1]
    positions = torch.arange(S, device=ids.device)
    if spec.pos_emb == "learned":
        x = x + params["embed_positions"][positions + spec.pos_offset]
        cos = sin = None
    else:
        cos, sin = rope_cos_sin(positions, spec.head_dim, spec.rope_theta)
    from asvd4llm_tpu_torch.models.decoder import decoder_layer
    latents = []
    for i, layer in enumerate(params["layers"]):
        if layer_uses_latent_v(layer):
            h = apply_norm(spec, layer["ln1"], x) if spec.family != "opt" or \
                spec.do_layer_norm_before else x
            tk = _latent(layer["k_proj"], h) \
                if is_lowrank(layer["k_proj"]) else None
            latents.append((tk, _latent(layer["v_proj"], h)))
        else:
            latents.append(None)
        mask = causal_mask(spec, i, positions, positions, None)
        x, _ = decoder_layer(spec, layer, x, cos, sin, mask,
                             la=layer_applier(spec, layer, i))
    return latents, final_hidden(params, spec, x)


def _prefilled(params, spec, input_ids, max_new_tokens, max_len, latent_kv,
               use_pallas, dtype):
    """The start of a greedy generation: (params, ids, caches, first token
    [B, 1]). With ``use_pallas`` the low-rank ranks are first zero-padded to
    the kernels' multiple (``align_ranks``, exact), so the latent caches are
    allocated padded."""
    if use_pallas:
        params = align_ranks(params, spec)
    dev = params["embed_tokens"].device
    ids = torch.as_tensor(np.asarray(input_ids), device=dev)
    B, S = ids.shape
    total = max_len or (S + max_new_tokens)
    dtype = dtype or params["embed_tokens"].dtype
    caches = init_caches(params, spec, B, total, dtype, latent=latent_kv,
                         device=dev)
    logits, caches = prefill_host(params, spec, ids, caches, latent=latent_kv)
    token = torch.argmax(logits, dim=-1)[:, None].to(ids.dtype)
    return params, ids, caches, token


@torch.no_grad()
def generate(params, spec, input_ids, *, max_new_tokens: int = 32,
             eos_token_id: Optional[int] = None, max_len: Optional[int] = None,
             latent_kv: bool = False, use_pallas: bool = False,
             dtype=None) -> np.ndarray:
    """Greedy generation on the params' device, one eager decode step and
    one host read per token. input_ids: [B, S] -> numpy [B, S + new]."""
    params, ids, caches, token = _prefilled(params, spec, input_ids, max_new_tokens,
                                            max_len, latent_kv, use_pallas, dtype)
    S = ids.shape[1]
    out = [np.asarray(input_ids)]
    finished = np.zeros((ids.shape[0],), bool)
    for step in range(max_new_tokens):
        tok_np = token.cpu().numpy()
        out.append(tok_np)
        if eos_token_id is not None:
            finished |= (tok_np[:, 0] == eos_token_id)
            if finished.all():
                break
        if step == max_new_tokens - 1:
            break
        logits, caches = decode_step(params, spec, token, caches, S + step,
                                     use_pallas=use_pallas)
        token = torch.argmax(logits, dim=-1)[:, None].to(ids.dtype)
    return np.concatenate(out, axis=1)


def _n_steps(tokens: np.ndarray, eos_token_id) -> int:
    """The JAX while-loop's step count for the emitted tokens [B, m]: the
    first step after which every row has emitted EOS, else m."""
    if eos_token_id is None:
        return tokens.shape[1]
    hit = tokens == eos_token_id
    if not hit.any(axis=1).all():
        return tokens.shape[1]
    return int(hit.argmax(axis=1).max()) + 1


class DecodeGraph:
    """Greedy decode steps over static device buffers, captured once as a
    CUDA graph and replayed: the counterpart of the JAX package's
    ``_decode_while`` body. The step records the current token in
    ``out[:, step]``, folds it into the finished flags, decodes it at
    ``pos`` and leaves the greedy next token in ``token``, then advances
    ``pos`` and ``step``; n replays decode n tokens with no host round
    trip. ``token0`` is the prefill's pick, ``caches`` are written in
    place. On a CPU tensor each replay runs the step eagerly (``generate``
    is the eager loop on any device).

    The last emitted token needs no decode, so a generation of m tokens is
    m - 1 replays and never writes a cache position past start_pos + m - 2.
    """

    def __init__(self, params, spec, token0, caches, start_pos: int,
                 max_new_tokens: int, eos_token_id=None, use_pallas=False):
        B = token0.shape[0]
        dev = token0.device
        T = _cache_len(caches[0])
        if start_pos + max_new_tokens - 1 > T:
            raise ValueError(f"a cache of {T} positions cannot decode {max_new_tokens}"
                             f" tokens after a prompt of {start_pos}")
        self.params, self.spec, self.caches = params, spec, caches
        self.eos_token_id, self.use_pallas = eos_token_id, use_pallas
        self.max_new_tokens = max_new_tokens
        self.token = token0.clone()
        self.pos = torch.tensor(start_pos, dtype=torch.int32, device=dev)
        self.step_i = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = torch.zeros((B, max(1, max_new_tokens - 1)), dtype=token0.dtype,
                               device=dev)
        self.finished = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.replays = 0
        self.graph = StepGraph(self._step, [self.token, self.pos, self.step_i, self.out,
                                            self.finished]) if max_new_tokens > 1 else None

    def _step(self):
        self.out.index_copy_(1, self.step_i.reshape(1), self.token)
        if self.eos_token_id is not None:
            self.finished |= self.token[:, 0] == self.eos_token_id
        logits, _ = decode_step(self.params, self.spec, self.token, self.caches,
                                self.pos, use_pallas=self.use_pallas)
        self.token.copy_(torch.argmax(logits, dim=-1)[:, None])
        self.pos += 1
        self.step_i += 1

    def replay(self, n: int):
        """n more decode steps (at most max_new_tokens - 1 in all)."""
        if self.replays + n > self.max_new_tokens - 1:
            raise ValueError(f"{self.replays} + {n} replays exceed the "
                             f"{self.max_new_tokens - 1} this decode holds")
        self.graph.replay(n)
        self.replays += n

    def run(self):
        """Replay until max_new_tokens are emitted or, reading the finished
        flags every READBACK_EVERY replays, every row has emitted EOS.
        Returns (tokens [B, m] numpy, n_steps): the emitted tokens and the
        JAX while-loop's step count; tokens[:, :n_steps] are valid."""
        limit = self.max_new_tokens - 1
        while self.replays < limit:
            self.replay(min(READBACK_EVERY, limit - self.replays))
            if self.eos_token_id is not None and bool(self.finished.all()):
                break
        tokens = torch.cat([self.out[:, :self.replays], self.token], dim=1)
        tokens = tokens[:, :self.max_new_tokens].cpu().numpy()
        return tokens, _n_steps(tokens, self.eos_token_id)


def _decode_while(params, spec, token0, caches, start_pos, max_new_tokens,
                  eos_token_id, use_pallas=False):
    """Greedy decode of up to max_new_tokens from token0 by a replayed CUDA
    graph with EOS early exit. Returns (tokens [B, m] numpy, n_steps), m <=
    max_new_tokens; tokens[:, :n_steps] are the valid emissions, as from
    the JAX package's ``_decode_while``."""
    if max_new_tokens <= 0:
        return np.zeros((token0.shape[0], 0), np.int64), 0
    dg = DecodeGraph(params, spec, token0, caches, start_pos, max_new_tokens,
                     eos_token_id, use_pallas)
    return dg.run()


@torch.no_grad()
def generate_on_device(params, spec, input_ids, *, max_new_tokens: int = 32,
                       eos_token_id: Optional[int] = None,
                       max_len: Optional[int] = None, latent_kv: bool = False,
                       use_pallas: bool = False, dtype=None) -> np.ndarray:
    """Greedy generation with the decode loop on the device: prefill as
    ``generate`` does, then one captured decode step replayed per token
    (eagerly on the CPU). Token-identical to ``generate``: rows that emitted
    EOS keep decoding greedily until every row has, and the surplus is
    cut."""
    params, ids, caches, token = _prefilled(params, spec, input_ids, max_new_tokens,
                                            max_len, latent_kv, use_pallas, dtype)
    out, n = _decode_while(params, spec, token, caches, ids.shape[1],
                           max_new_tokens, eos_token_id, use_pallas=use_pallas)
    return np.concatenate([np.asarray(input_ids), out[:, :n]], axis=1)


def generate_auto(params, spec, input_ids, **kw) -> np.ndarray:
    """Greedy generation by the replayed decode graph when the params live
    on a CUDA device (one graph launch per token instead of a step of eager
    launches and a host read) and by the host loop elsewhere; both are
    token-identical."""
    if params["embed_tokens"].device.type == "cuda":
        return generate_on_device(params, spec, input_ids, **kw)
    return generate(params, spec, input_ids, **kw)
