"""Paged low-rank KV cache for serving mixed-length requests.

Counterpart of asvd4llm_tpu/serving/paged.py. Cache memory is a pool of
fixed-size pages shared by all sequences (the vLLM PagedAttention layout):

  pool      [num_pages, page, ...]   one tensor per layer per cache kind
  page_table[B, max_pages] int32     logical page p of sequence b -> pool id
  positions [B] int32                per-sequence decode position (ragged)

All three cache layouts page alike: dense {k, v}, latent {tk, tv} (rank-dim
latents, the realized KV compression) and latent-V-only {k, tv}. Page 0 is
a reserved scratch page: inactive batch rows point every logical page at
it, so their (masked, ignored) writes never touch live data.

Pools are updated in place with ``index_copy_`` / ``index_put_`` (the JAX
package returns new arrays and donates the old ones): a decode step or an
append writes its entries into the pools it was given and returns the same
dicts, so their addresses never change.

``PagedDecoder`` is the counterpart of the JAX package's jitted
``paged_decode_step`` / ``paged_decode_scan``: one ragged step over static
token, position and page-table buffers, captured as a CUDA graph and
replayed n times for n tokens (utils/graphs.py); the engine keeps one.

Reads either go through the paged flash-decoding kernels (``use_pallas``,
ops/paged_attention.py: kernel 6 for ``"kv"`` pools with RoPE and no k bias,
kernel 5 for dense and ``"v"`` pools) or gather the pages into a [B, T, ...]
view for the plain attention of eval/generate.py with a per-sequence [B, T]
mask, as the JAX package's fallback does.
"""

from __future__ import annotations

import hashlib

import torch

from asvd4llm_tpu_torch.eval.generate import (
    NEG, _absorbed_v_out, _apply_leaf, _decode_layer, _gqa_probs, _latent,
    _up_k, init_caches, prefill_host,
)
from asvd4llm_tpu_torch.models.decoder import (
    apply_lm_head, apply_rope, attn_scale, embed, final_hidden, rope_cos_sin,
)
from asvd4llm_tpu_torch.ops.paged_attention import (
    _flat_rows as _flat_view, paged_dense_decode_attention,
    paged_latent_decode_attention,
)
from asvd4llm_tpu_torch.utils.graphs import StepGraph


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


def default_page_size(kv_heads: int, head_dim: int, itemsize: int = 2, *,
                      target_bytes: int = 2 << 20, lo: int = 64,
                      hi: int = 2048) -> int:
    """Page size sized by bytes, not tokens: the K page holds about
    ``target_bytes`` (P·KV·hd·itemsize) at every KV-head count, so the fixed
    per-page costs of the paged kernels amortize alike for MHA and GQA.
    Power of 2, clamped to [lo, hi]; the JAX package's rule, kept so that
    both packages pick the same geometry."""
    raw = target_bytes // max(1, kv_heads * head_dim * itemsize)
    p = lo
    while p * 2 <= raw and p * 2 <= hi:
        p *= 2
    return p


def init_paged_pools(params, spec, num_pages: int, page_size: int,
                     dtype=torch.float32, *, latent=False, device=None) -> list:
    """Per-layer page pools: eval.generate.init_caches with the leading
    [B, max_len] read as [num_pages, page_size]."""
    return init_caches(params, spec, num_pages, page_size, dtype,
                       latent=latent, device=device)


def _scatter_token(pool, page_table, positions, val):
    """Write one token's value per sequence in place: val [B, ...] lands at
    (page_table[b, pos_b // P], pos_b % P), row pages·P + pos % P of the
    pool seen as [NP·P, ...]."""
    P = pool.shape[1]
    pos = positions.long()
    pages = page_table.long().gather(1, (pos // P)[:, None])[:, 0]
    pool.view(-1, *pool.shape[2:]).index_copy_(0, pages * P + pos % P,
                                               val.to(pool.dtype))
    return pool


def _rope_one(x, cos_b, sin_b):
    """Per-sequence single-position RoPE: x [B, KV, hd], cos/sin [B, hd]."""
    return _rope_rows(x[:, None], cos_b[:, None], sin_b[:, None])[:, 0]


def _ragged_mask(positions, T, sliding):
    """[B, T] additive mask: 0 where key t ≤ positions[b] (and inside the
    sliding window), -1e30 elsewhere."""
    k_pos = torch.arange(T, device=positions.device)
    pos = positions.long()[:, None]
    allow = k_pos[None, :] <= pos
    if sliding:
        allow &= k_pos[None, :] > pos - sliding
    return torch.where(allow, 0.0, NEG).float()


def _paged_attend(spec, layer, x, cache, positions, cos_full, sin_full,
                  layer_idx, up=False):
    """Paged mirror of eval.generate._attend_step with per-sequence
    positions. cache = {"pools": the layer's pool dict, "pt": page_table};
    the pools are written in place."""
    pools, pt = cache["pools"], cache["pt"]
    B = x.shape[0]
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    P = next(iter(pools.values())).shape[1]
    T = pt.shape[1] * P
    rep = H // KV
    o_key = "o_proj" if "o_proj" in layer else "out_proj"

    q = _apply_leaf(layer["q_proj"], x, up).reshape(B, 1, H, hd)
    pos_l = positions.long()
    cos_q, sin_q = cos_full[pos_l], sin_full[pos_l]            # [B, hd]
    if spec.pos_emb == "rope":
        q = _rope_one(q[:, 0], cos_q, sin_q)[:, None]

    scale = attn_scale(spec)
    sliding = spec.sliding_window if spec.layer_uses_sliding(layer_idx) else 0

    if "tk" in pools:  # latent kv
        _scatter_token(pools["tk"], pt, positions, _latent(layer["k_proj"], x)[:, 0])
        _scatter_token(pools["tv"], pt, positions, _latent(layer["v_proj"], x)[:, 0])
        tk_pool, tv_pool = pools["tk"], pools["tv"]
        if up and spec.pos_emb == "rope" and layer["k_proj"]["b"] is None:
            # kernel 6: streams the row's own pages, never the [B, T] gather
            out = paged_latent_decode_attention(
                q[:, 0], tk_pool, tv_pool, layer["k_proj"]["A"],
                layer["v_proj"]["A"], cos_full[:T], sin_full[:T], pt,
                positions, kv_heads=KV, scale=scale,
                softcap=spec.attn_logit_softcap, sliding=sliding,
                v_bias=layer["v_proj"]["b"])
            return _apply_leaf(layer[o_key], out.to(x.dtype)[:, None, :], up), cache
        k = _up_k(layer["k_proj"], _flat_view(tk_pool, pt), B, T, KV, hd)
        if spec.pos_emb == "rope":
            # logical page positions are absolute sequence positions
            k = apply_rope(k, cos_full[:T], sin_full[:T])
        probs = _gqa_probs(q[:, 0], k, rep, scale, spec.attn_logit_softcap,
                           _ragged_mask(positions, T, sliding))
        out = _absorbed_v_out(probs, _flat_view(tv_pool, pt), layer["v_proj"],
                              KV, hd, rep, x.dtype)
    elif "tv" in pools:  # dense K + latent V
        k_new = _apply_leaf(layer["k_proj"], x, up).reshape(B, KV, hd)
        if spec.pos_emb == "rope":
            k_new = _rope_one(k_new, cos_q, sin_q)
        _scatter_token(pools["k"], pt, positions, k_new)
        _scatter_token(pools["tv"], pt, positions, _latent(layer["v_proj"], x)[:, 0])
        if up:
            # kernel 5, V-latent variant
            out = paged_dense_decode_attention(
                q[:, 0], pools["k"], pools["tv"], pt, positions, kv_heads=KV,
                scale=scale, softcap=spec.attn_logit_softcap, sliding=sliding,
                a_v=layer["v_proj"]["A"], v_bias=layer["v_proj"]["b"])
            return _apply_leaf(layer[o_key], out.to(x.dtype)[:, None, :], up), cache
        probs = _gqa_probs(q[:, 0], _flat_view(pools["k"], pt), rep, scale,
                           spec.attn_logit_softcap,
                           _ragged_mask(positions, T, sliding))
        out = _absorbed_v_out(probs, _flat_view(pools["tv"], pt), layer["v_proj"],
                              KV, hd, rep, x.dtype)
    else:  # dense
        k_new = _apply_leaf(layer["k_proj"], x, up).reshape(B, KV, hd)
        v_new = _apply_leaf(layer["v_proj"], x, up).reshape(B, KV, hd)
        if spec.pos_emb == "rope":
            k_new = _rope_one(k_new, cos_q, sin_q)
        _scatter_token(pools["k"], pt, positions, k_new)
        _scatter_token(pools["v"], pt, positions, v_new)
        if up:
            # kernel 5, dense V: no [B, T] gather copy
            out = paged_dense_decode_attention(
                q[:, 0], pools["k"], pools["v"], pt, positions, kv_heads=KV,
                scale=scale, softcap=spec.attn_logit_softcap, sliding=sliding)
            return _apply_leaf(layer[o_key], out.to(x.dtype)[:, None, :], up), cache
        v = _flat_view(pools["v"], pt)
        probs = _gqa_probs(q[:, 0], _flat_view(pools["k"], pt), rep, scale,
                           spec.attn_logit_softcap,
                           _ragged_mask(positions, T, sliding))
        out = torch.einsum("bgrk,bkgd->bgrd", probs.to(v.dtype).float(), v.float())
        out = out.to(x.dtype).reshape(B, 1, H * hd)
    return _apply_leaf(layer[o_key], out, up), cache


def _rope_table(spec, T, device):
    if spec.pos_emb == "learned":
        z = torch.zeros((T, spec.head_dim), device=device)
        return z, z
    return rope_cos_sin(torch.arange(T, device=device), spec.head_dim,
                        spec.rope_theta)


@torch.no_grad()
def paged_decode_step(params, spec, token, pools, page_table, positions,
                      use_pallas=False):
    """One ragged decode step over paged caches.

    token [B, 1]; pools: per-layer pool dicts (written in place);
    page_table [B, MP] int32; positions [B] int32 (each sequence's slot for
    this token). Returns (logits [B, vocab] f32, pools)."""
    x = embed(params, spec, token)
    P = next(iter(pools[0].values())).shape[1]
    T = page_table.shape[1] * P
    if spec.pos_emb == "learned":
        x = x + params["embed_positions"][positions.long() + spec.pos_offset][:, None]
    cos_full, sin_full = _rope_table(spec, T, token.device)
    for i, layer in enumerate(params["layers"]):
        x, _ = _decode_layer(spec, layer, x, {"pools": pools[i], "pt": page_table},
                             positions, cos_full, sin_full, i, up=use_pallas,
                             attend=_paged_attend)
    x = final_hidden(params, spec, x)
    logits = apply_lm_head(params, spec, x, use_pallas=use_pallas)[:, 0]
    return logits, pools


# ------------------------------------------------------------- sampling --

def _top_p_keep(z, top_p: float):
    """Top-p keep mask of scaled logits z [B, V]: the smallest prefix of
    descending-probability tokens whose exclusive cumulative mass is
    < top_p (the JAX package's rule)."""
    p = torch.softmax(z, dim=-1)
    ps, order = torch.sort(p, dim=-1, descending=True, stable=True)
    keep_sorted = (torch.cumsum(ps, dim=-1) - ps) < top_p
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def _sample_rows(logits, gumbel, temperature: float, top_p: float):
    """Temperature/top-p sampling of one token per row by the Gumbel-argmax
    trick (no renormalization needed): argmax over kept tokens of
    logits/temperature + gumbel. logits, gumbel [B, V] -> [B] int32."""
    z = logits.float() / temperature
    z_masked = torch.where(_top_p_keep(z, top_p), z, torch.full_like(z, -float("inf")))
    return torch.argmax(z_masked + gumbel.to(z.device), dim=-1).to(torch.int32)


def _row_seed(seed: int, rid: int, q: int) -> int:
    """The seed of the noise for the token at sequence index q of request
    rid: the first 8 bytes of SHA-256 over the three numbers, as a
    non-negative int63 (a documented mix, so any caller derives the same
    noise)."""
    digest = hashlib.sha256(f"{seed}:{rid}:{q}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _gumbel_noise(seed: int, rid: int, q: int, vocab: int):
    """Gumbel(0, 1) noise [vocab] f32 from a CPU torch.Generator seeded by
    _row_seed, so every device draws the same numbers."""
    g = torch.Generator().manual_seed(_row_seed(seed, rid, q))
    u = torch.rand(vocab, generator=g, dtype=torch.float64)
    return (-torch.log(-torch.log(u.clamp_min(1e-300)))).float()


def _sample_each(logits, noise, temperature: float, top_p: float):
    """Rows sampled one at a time with their noise rows, so a row's result
    never depends on the batch around it. logits, noise [B, V] -> [B]
    int32."""
    return torch.cat([_sample_rows(logits[i:i + 1], noise[i:i + 1], temperature, top_p)
                      for i in range(logits.shape[0])])


def sample_rows_keyed(logits, rids, positions, seed: int, temperature: float,
                      top_p: float):
    """Stateless per-(request, position) sampling: the token at sequence
    index q of request rid draws its noise from (seed, rid, q) alone, so
    stepwise and multi-step scheduling (any chunk size, any admission
    order) emit the same tokens. logits [B, V]; rids and positions: B ints
    -> [B] int32 on the logits' device."""
    V = logits.shape[-1]
    noise = torch.stack([_gumbel_noise(seed, int(r), int(q), V)
                         for r, q in zip(rids, positions)])
    return _sample_each(logits, noise, temperature, top_p)


def chunk_noise(seed: int, rids, positions, n_steps: int, vocab: int):
    """The noise of n_steps decode steps drawn before them: [n_steps, B, V]
    f32 on the CPU, noise[s, b] the noise of the token at sequence index
    positions[b] + s + 1 of request rids[b] (step s writes at
    positions[b] + s and emits the next token), as sample_rows_keyed draws
    it row by row."""
    return torch.stack([torch.stack([_gumbel_noise(seed, int(r), int(p) + s + 1, vocab)
                                     for r, p in zip(rids, positions)])
                        for s in range(n_steps)])


class PagedDecoder:
    """Ragged decode steps over static buffers, one CUDA graph per n_steps.

    The buffers are ``token`` [B, 1], ``positions`` [B] int32 and
    ``page_table`` [B, MP] int32, a step counter and, per n_steps, an output
    buffer [B, n_steps] and (when sampling) the chunk's noise [n_steps, B,
    V]. One step decodes ``token`` at ``positions`` over ``pools`` (written
    in place, so their addresses are static), picks the next token greedily
    or from the noise row of its step, stores it in the output column of
    its step, and advances ``token``, ``positions`` and the counter. A scan
    of n_steps is n_steps replays of the graph captured for n_steps
    (captured on its first use). On a CPU device, or with ``eager``
    (measurements only, as ``form=`` on the kernel wrappers), the same step
    runs eagerly."""

    def __init__(self, params, spec, pools, batch: int, max_pages: int, *,
                 use_pallas=False, temperature=0.0, top_p=1.0, seed=0,
                 eager=False):
        dev = params["embed_tokens"].device
        self.params, self.spec, self.pools = params, spec, pools
        self.use_pallas, self.eager = use_pallas, eager
        self.temperature, self.top_p, self.seed = float(temperature), float(top_p), int(seed)
        self.token = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        self.positions = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.page_table = torch.zeros((batch, max_pages), dtype=torch.int32, device=dev)
        self.step_i = torch.zeros((), dtype=torch.int64, device=dev)
        self.graphs: dict = {}      # n_steps -> (StepGraph, out, noise or None)

    def _build(self, n_steps: int):
        B, dev = self.token.shape[0], self.token.device
        out = torch.zeros((B, n_steps), dtype=torch.int64, device=dev)
        noise = None
        if self.temperature > 0:
            noise = torch.zeros((n_steps, B, self.spec.vocab_size), dtype=torch.float32,
                                device=dev)

        def step():
            logits, _ = paged_decode_step(self.params, self.spec, self.token, self.pools,
                                          self.page_table, self.positions,
                                          use_pallas=self.use_pallas)
            if noise is None:
                nxt = torch.argmax(logits, dim=-1)
            else:
                rows = noise.index_select(0, self.step_i.reshape(1))[0]
                nxt = _sample_each(logits, rows, self.temperature, self.top_p)
            out.index_copy_(1, self.step_i.reshape(1), nxt[:, None].to(out.dtype))
            self.token.copy_(nxt[:, None])
            self.positions += 1
            self.step_i += 1

        state = [self.token, self.positions, self.step_i, out]
        return StepGraph(step, state, eager=self.eager), out, noise

    @torch.no_grad()
    def scan(self, token, page_table, positions, n_steps: int, rids=None):
        """n_steps decode steps from ``token`` [B, 1] at ``positions`` [B]
        over ``page_table`` [B, MP] (host arrays or tensors, copied into
        the static buffers). ``rids`` (B ints) key the sampling noise.
        Returns the tokens [B, n_steps] on the device (the graph's output
        buffer: read it before the next scan of n_steps)."""
        B = self.token.shape[0]
        self.token.copy_(torch.as_tensor(token).reshape(B, 1))
        self.positions.copy_(torch.as_tensor(positions))
        self.page_table.copy_(torch.as_tensor(page_table))
        self.step_i.zero_()
        if n_steps not in self.graphs:
            # the capture's warm-up step samples from a zero noise buffer; it
            # writes the pools as the first replay will, whatever it samples
            self.graphs[n_steps] = self._build(n_steps)
        graph, out, noise = self.graphs[n_steps]
        if noise is not None:
            # drawn on the host before the replays: the positions are known
            rid_list = [0] * B if rids is None else [int(r) for r in rids]
            noise.copy_(chunk_noise(self.seed, rid_list,
                                    torch.as_tensor(positions).cpu().tolist(),
                                    n_steps, self.spec.vocab_size))
        graph.replay(n_steps)
        return out


@torch.no_grad()
def paged_decode_scan(params, spec, token, pools, page_table, positions,
                      n_steps, use_pallas=False, temperature=0.0, top_p=1.0,
                      seed=0, rids=None):
    """n_steps ragged decode steps with no host round trip between them,
    through a PagedDecoder (on a CUDA device one graph, captured for this
    call: a caller that scans repeatedly keeps one PagedDecoder, as the
    engine does, and pays the capture once per n_steps). Returns (tokens
    [B, n_steps], pools) — greedy at temperature 0, position-keyed
    temperature/top-p sampling otherwise (the same tokens as the engine's
    stepwise sampler). Rows that hit EOS mid-chunk keep decoding; the
    engine drops their surplus tokens."""
    dec = PagedDecoder(params, spec, pools, *page_table.shape, use_pallas=use_pallas,
                       temperature=temperature, top_p=top_p, seed=seed)
    toks = dec.scan(token, page_table, positions, n_steps, rids)
    return toks.to(token.dtype).clone(), pools


# ------------------------------------------------------ chunked prefill --

def _scatter_segment(pool, page_table, positions, vals):
    """Write C-token segments of B sequences in place: vals [B, C, ...]
    land at (page_table[b, pos_bc // P], pos_bc % P). Positions past the
    row's allocated pages (or past its page table) resolve to the scratch
    page 0 (the padded tail of the last chunk, or whole padded rows) and
    are never read back."""
    P = pool.shape[1]
    MP = page_table.shape[1]
    pos = positions.long()
    idx = pos // P
    pages = page_table.long().gather(1, idx.clamp(max=MP - 1))
    pages = torch.where(idx < MP, pages, torch.zeros_like(pages))
    pool.index_put_((pages, pos % P), vals.to(pool.dtype))
    return pool


def _rope_rows(x, cos_bc, sin_bc):
    """Per-row-position RoPE: x [B, C, H, hd]; cos/sin [B, C, hd]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos_bc[:, :, None, :].float()
    s = sin_bc[:, :, None, :].float()
    return (x.float() * c + rot.float() * s).to(x.dtype)


def _absorbed_v_rows(probs, tv, v_leaf, KV, hd, x_dtype):
    """probs [B, g, r, C, T] over V latents tv [B, T, Rv] -> [B, C, H*hd]
    (the A_v up-projection per group, + the v bias)."""
    B, _, rep, C, _ = probs.shape
    s = torch.einsum("bgrqk,bkv->bgrqv", probs.to(tv.dtype).float(), tv.float())
    a_v = v_leaf["A"].reshape(KV, hd, -1)
    out = torch.einsum("bgrqv,gdv->bqgrd", s.to(a_v.dtype).float(), a_v.float())
    if v_leaf["b"] is not None:
        out = out + v_leaf["b"].float().reshape(KV, hd)[None, None, :, None, :]
    return out.to(x_dtype).reshape(B, C, KV * rep * hd)


def _append_attend(spec, layer, x, cache, pos0, cos_full, sin_full, layer_idx,
                   up=False):
    """Multi-token paged append-attention for a batch of sequences (chunked
    prefill): x [B, C, hidden], row b at positions pos0[b]..pos0[b]+C-1;
    writes each segment's cache entries into that row's pages, then attends
    each query causally over everything written so far. ``up`` is accepted
    for _decode_layer and unused (the fused kernels are decode-only)."""
    pools, pt = cache["pools"], cache["pt"]
    B, C = x.shape[0], x.shape[1]
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    P = next(iter(pools.values())).shape[1]
    T = pt.shape[1] * P
    rep = H // KV
    positions = pos0.long()[:, None] + torch.arange(C, device=x.device)[None, :]
    # padded tail positions past T read the last table row (their queries
    # are discarded, their writes go to the scratch page)
    pos_c = positions.clamp(max=T - 1)

    q = _apply_leaf(layer["q_proj"], x, False).reshape(B, C, H, hd)
    cos_c, sin_c = cos_full[pos_c], sin_full[pos_c]           # [B, C, hd]
    if spec.pos_emb == "rope":
        q = _rope_rows(q, cos_c, sin_c)

    scale = attn_scale(spec)
    k_pos = torch.arange(T, device=x.device)
    allow = k_pos[None, None, :] <= positions[:, :, None]     # [B, C, T]
    if spec.layer_uses_sliding(layer_idx):
        allow &= k_pos[None, None, :] > positions[:, :, None] - spec.sliding_window
    mask = torch.where(allow, 0.0, NEG).float()[:, None, None]

    def probs_of(k):
        qg = q.reshape(B, C, KV, rep, hd)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * scale
        if spec.attn_logit_softcap > 0:
            cap = spec.attn_logit_softcap
            logits = cap * torch.tanh(logits / cap)
        return torch.softmax(logits + mask, dim=-1)          # [B, g, r, C, T]

    if "tk" in pools:  # latent kv
        _scatter_segment(pools["tk"], pt, positions, _latent(layer["k_proj"], x))
        _scatter_segment(pools["tv"], pt, positions, _latent(layer["v_proj"], x))
        k = _up_k(layer["k_proj"], _flat_view(pools["tk"], pt), B, T, KV, hd)
        if spec.pos_emb == "rope":
            k = apply_rope(k, cos_full[:T], sin_full[:T])
        out = _absorbed_v_rows(probs_of(k), _flat_view(pools["tv"], pt),
                               layer["v_proj"], KV, hd, x.dtype)
    else:
        k_new = _apply_leaf(layer["k_proj"], x, False).reshape(B, C, KV, hd)
        if spec.pos_emb == "rope":
            k_new = _rope_rows(k_new, cos_c, sin_c)
        _scatter_segment(pools["k"], pt, positions, k_new)
        if "tv" in pools:  # dense K + latent V
            _scatter_segment(pools["tv"], pt, positions, _latent(layer["v_proj"], x))
            out = _absorbed_v_rows(probs_of(_flat_view(pools["k"], pt)),
                                   _flat_view(pools["tv"], pt), layer["v_proj"],
                                   KV, hd, x.dtype)
        else:  # dense
            v_new = _apply_leaf(layer["v_proj"], x, False).reshape(B, C, KV, hd)
            _scatter_segment(pools["v"], pt, positions, v_new)
            v = _flat_view(pools["v"], pt)
            probs = probs_of(_flat_view(pools["k"], pt))
            out = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(v.dtype).float(),
                               v.float())
            out = out.to(x.dtype).reshape(B, C, H * hd)

    o_key = "o_proj" if "o_proj" in layer else "out_proj"
    return _apply_leaf(layer[o_key], out, False), cache


def _append_hidden(params, spec, ids, pools, page_table, pos0):
    """Shared body of the batched paged append: write every row's C-token
    segment into its pages and return the final hidden states [B, C,
    hidden]; the wrappers apply the lm_head."""
    x = embed(params, spec, ids)
    P = next(iter(pools[0].values())).shape[1]
    T = page_table.shape[1] * P
    C = ids.shape[1]
    if spec.pos_emb == "learned":
        positions = pos0.long()[:, None] + torch.arange(C, device=ids.device)[None, :]
        table = params["embed_positions"]
        x = x + table[(positions + spec.pos_offset).clamp(max=table.shape[0] - 1)]
    cos_full, sin_full = _rope_table(spec, T, ids.device)
    for i, layer in enumerate(params["layers"]):
        x, _ = _decode_layer(spec, layer, x, {"pools": pools[i], "pt": page_table},
                             pos0, cos_full, sin_full, i, up=False,
                             attend=_append_attend)
    return final_hidden(params, spec, x)


@torch.no_grad()
def paged_append_batch(params, spec, ids, pools, page_table, pos0):
    """Append C-token segments of B sequences to their paged caches and
    return (logits [B, C, vocab], pools). ids [B, C]; page_table [B, MP]
    (rows of padded or inactive requests all zeros -> scratch); pos0 [B]
    per-row start positions. The chunked-prefill building block."""
    x = _append_hidden(params, spec, ids, pools, page_table, pos0)
    return apply_lm_head(params, spec, x), pools


@torch.no_grad()
def paged_append_batch_select(params, spec, ids, pools, page_table, pos0,
                              rows, cols):
    """paged_append_batch, but the lm_head runs only on the gathered
    (rows[i], cols[i]) hidden states — returns (logits [K, vocab], pools).
    The admission tick needs next-token logits only for requests whose
    prompt completes in this segment; padded entries gather (0, 0) and are
    ignored by the caller."""
    x = _append_hidden(params, spec, ids, pools, page_table, pos0)
    h = x[rows.long(), cols.long()]                          # [K, hidden]
    return apply_lm_head(params, spec, h[:, None])[:, 0], pools


def paged_append(params, spec, ids, pools, page_table_row, pos0):
    """Single-sequence wrapper over paged_append_batch: ids [1, C] +
    page_table_row [MP] -> (logits [C, vocab], pools)."""
    dev = params["embed_tokens"].device
    logits, pools = paged_append_batch(
        params, spec, torch.as_tensor(ids, device=dev), pools,
        torch.as_tensor(page_table_row, device=dev).to(torch.int32)[None, :],
        torch.tensor([int(pos0)], dtype=torch.int32, device=dev))
    return logits[0], pools


def prefill_chunked_into_pages(params, spec, ids, pools, page_table_row,
                               chunk: int):
    """Prefill ids [1, S] in ``chunk``-token segments via paged_append. The
    last segment is padded; padded positions write to the scratch page or
    to slots that decode overwrites before reading. page_table_row: int32
    [max_pages] with this sequence's pages set (0 elsewhere). Returns
    (last-real-position logits [1, vocab], pools)."""
    dev = params["embed_tokens"].device
    arr = torch.as_tensor(ids, device=dev)
    S = arr.shape[1]
    logits = None
    for c0 in range(0, S, chunk):
        seg = arr[:, c0:c0 + chunk]
        if seg.shape[1] < chunk:
            seg = torch.nn.functional.pad(seg, (0, chunk - seg.shape[1]))
        logits, pools = paged_append(params, spec, seg, pools, page_table_row, c0)
    return logits[(S - 1) % chunk][None], pools


def _pool_mode(pools):
    """The latent mode the pools were made with, from every layer (a layer
    without low-rank k and v keeps a dense cache in any mode; the JAX
    package reads layer 0 only, which fails when layer 0 is such a
    layer)."""
    if any("tk" in p for p in pools):
        return True
    if any("tv" in p for p in pools):
        return "v"
    return False


@torch.no_grad()
def prefill_into_pages(params, spec, ids, pools, page_ids):
    """Prefill one sequence (ids [1, S]) and write its cache into the
    given pages in place. page_ids: >= ceil(S/P) pool pages. Returns
    (last-position logits [1, vocab], pools)."""
    dev = params["embed_tokens"].device
    ids = torch.as_tensor(ids, device=dev)
    S = ids.shape[1]
    P = next(iter(pools[0].values())).shape[1]
    n = pages_needed(S, P)
    if len(page_ids) < n:
        raise ValueError(f"{S} tokens need {n} pages of {P}, got {len(page_ids)}")
    latent = _pool_mode(pools)
    dtype = next(iter(pools[0].values())).dtype
    flat = init_caches(params, spec, 1, n * P, dtype, latent=latent, device=dev)
    logits, filled = prefill_host(params, spec, ids, flat, latent=latent)
    pages = torch.as_tensor(list(page_ids[:n]), dtype=torch.long, device=dev)
    for pool, cache in zip(pools, filled):
        for key, arr in pool.items():
            arr.index_copy_(0, pages, cache[key][0].reshape(n, P, *arr.shape[2:])
                            .to(arr.dtype))
    return logits, pools
