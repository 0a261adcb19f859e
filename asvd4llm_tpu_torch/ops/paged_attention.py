"""Paged flash-decoding for the serving engine — kernels 5 and 6.

Ports of asvd4llm_tpu/ops/pallas_latent_attention.py::_paged_dense_core
(public wrapper ``paged_dense_decode_attention``) and ::_paged_latent_core
(``paged_latent_decode_attention``). One decode step of a batch whose rows
sit at ragged positions ``positions [B]`` and whose caches live in page
pools ``[NP, P, ...]``: logical key t of row b is pool row
``page_table[b, t // P]``, slot ``t % P``. Per query head h of KV group g,
over the keys t ≤ positions[b] (and inside the sliding window):

  kernel 5  K = the pre-rotated dense K pool [NP,P,KV,hd];
            V dense [NP,P,KV,hd] → s [B,H,hd], or V-latent [NP,P,Rv]
            → s [B,H,Rv] (A_v up-projects it in this wrapper)
  kernel 6  K = RoPE(tk · A_kᵀ) from the latent pool [NP,P,Rk] with the
            cos/sin rows of the logical positions; V-latent [NP,P,Rv]
  p         softmax numerator of scale·q·K (+ softcap), -1e30 masks
  s_h       Σ_t p_t (rounded to the pool's dtype) · V_t / Σ_t p_t, f32

The kernels are hand-written CUDA (``csrc/paged_dense_attention.cu``,
``csrc/paged_latent_attention.cu``); each call is two launches, the row's
keys split into chunks over blocks and then the chunks combined, with a
workspace the wrapper allocates. Kernel 6 has two forms, named by
``_latent_form`` from the shape: "split_wgmma" (kernel 2's split tile,
``csrc/latent_split.cuh``, its 128-key chunk rows loaded by page in TMA
boxes that ``split_boxes`` describes) and "tile32" (kernel 2's 32-key tile
body in ``csrc/flash_decode.cuh``). Kernel 5 has two forms, named by
``_dense_form``: "split_tma" (64-key chunks loaded by page in TMA boxes,
``split_boxes(..., chunk=DENSE_SPLIT_KEYS)``; a V-latent block covers a head
block of KV groups that its launcher picks) and "tile32" (the same 32-key
tile body). ``paged_dense_reference`` and ``paged_latent_reference`` are
the plain PyTorch versions with the same casts, and a CPU tensor takes
them; ``paged_latent_split_reference`` and ``paged_dense_split_reference``
are the plain versions of what the split forms compute per chunk. The
query enters in f32 (the JAX kernels cast it to f32 too), so pools of
another dtype than the model compute what the JAX package computes. Page ids must lie in the pool and positions below
``MP·P``; the engine guarantees both.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from asvd4llm_tpu_torch.ops import _build
from asvd4llm_tpu_torch.ops.latent_attention import (
    _DTYPE_CODES, _FORM_CODES, _HEAD_DIMS, _MAX_REP, _MAX_SMEM, _SPLIT_HEAD_DIMS, SPLIT_KEYS,
    _rotate_half,
)

_DENSE_FORM_CODES = {"tile32": 0, "split_tma": 1}
DENSE_SPLIT_KEYS = 64   # keys per block of kernel 5's split form (kChunk in its source)


def _dense_form(dtype: torch.dtype, hd: int, SV: int, P: int, aligned: bool = True) -> str:
    """The kernel form a call of kernel 5 runs: "split_tma" (bf16, head dim
    64 or 128, V width SV (hd, or Rv for V-latent) a multiple of 8,
    16-byte aligned pools, page size a power of two of at least 8), else
    "tile32"."""
    if (dtype == torch.bfloat16 and hd in _SPLIT_HEAD_DIMS and SV % 8 == 0
            and P >= 8 and P & (P - 1) == 0 and aligned):
        return "split_tma"
    return "tile32"


def _latent_form(dtype: torch.dtype, hd: int, Rk: int, Rv: int, P: int,
                 aligned: bool = True) -> str:
    """The kernel form a call of kernel 6 runs: "split_wgmma" (bf16, head
    dim 64 or 128, Rk and Rv multiples of 8, 16-byte aligned pools and A_k,
    page size a power of two of at least 8), else "tile32"."""
    if (dtype == torch.bfloat16 and hd in _SPLIT_HEAD_DIMS and Rk % 8 == 0
            and Rv % 8 == 0 and P >= 8 and P & (P - 1) == 0 and aligned):
        return "split_wgmma"
    return "tile32"


def split_boxes(P: int, MP: int, pos: int, sliding: int, chunk: int = SPLIT_KEYS):
    """The split form's loads for one row, as its producer issues them:
    {chunk j: [(first stage row, rows, logical page loaded, row in page)]}
    for every chunk of the row's MP·P keys that holds a live key of
    [pos − sliding + 1, pos]; the other chunks are marked empty. P >= chunk:
    one box of `chunk` rows inside one page; P < chunk: chunk / P boxes of P
    rows, a logical page outside the live ones clamped to the nearest live
    page (its keys are masked)."""
    t_lo = max(0, pos - sliding + 1) if sliding > 0 else 0
    lo, hi = t_lo // P, pos // P
    out = {}
    for j in range(-(-MP * P // chunk)):
        c0 = j * chunk
        if c0 > pos or c0 + chunk <= t_lo:
            continue
        if P >= chunk:
            out[j] = [(0, chunk, c0 // P, c0 % P)]
        else:
            out[j] = [(i * P, P, min(max(c0 // P + i, lo), hi), 0) for i in range(chunk // P)]
    return out


def _flat_rows(pool, page_table):
    """pool [NP, P, ...] + page_table [B, MP] -> [B, MP*P, ...] gather."""
    g = pool[page_table.long()]
    B, MP, P = g.shape[:3]
    return g.reshape(B, MP * P, *pool.shape[2:])


def _paged_softmax_v(qg, k, v, v_dtype, positions, *, scale, softcap, sliding):
    """The shared plain math: qg [B,KV,rep,hd] f32, k [B,T,KV,hd] f32, v
    [B,T,KV,hd] or [B,T,Rv] f32 -> s [B, KV*rep, hd or Rv] f32."""
    B, KV, rep, _ = qg.shape
    T = k.shape[1]
    logits = torch.einsum("bgrd,btgd->bgrt", qg, k) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    k_pos = torch.arange(T, device=k.device)
    pos = positions.long()[:, None]
    allow = k_pos[None, :] <= pos
    if sliding > 0:
        allow &= k_pos[None, :] > pos - sliding
    logits = torch.where(allow[:, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    den = p.sum(dim=-1)
    pv = p.to(v_dtype).float()
    if v.dim() == 4:
        num = torch.einsum("bgrt,btgd->bgrd", pv, v)
    else:
        num = torch.einsum("bgrt,btv->bgrv", pv, v)
    return (num / den[..., None]).reshape(B, KV * rep, -1)


def paged_dense_reference(q_rot, k_pool, v_pool, page_table, positions, *,
                          scale, softcap, sliding, kv_heads):
    """Plain version of kernel 5: -> s [B, H, hd] (dense V) or [B, H, Rv]
    (V-latent) f32."""
    B, H, hd = q_rot.shape
    qg = q_rot.float().reshape(B, kv_heads, H // kv_heads, hd)
    k = _flat_rows(k_pool, page_table).float()
    v = _flat_rows(v_pool, page_table).float()
    return _paged_softmax_v(qg, k, v, v_pool.dtype, positions, scale=scale,
                            softcap=softcap, sliding=sliding)


def paged_latent_reference(q_rot, tk_pool, tv_pool, a_k, cos_full, sin_full,
                           page_table, positions, *, scale, softcap, sliding,
                           kv_heads):
    """Plain version of kernel 6: -> s [B, H, Rv] f32."""
    B, H, hd = q_rot.shape
    tk = _flat_rows(tk_pool, page_table)
    T = tk.shape[1]
    k = torch.matmul(tk.float(), a_k.float().t()).reshape(B, T, kv_heads, hd)
    c = cos_full[:T].float()[None, :, None, :]
    s = sin_full[:T].float()[None, :, None, :]
    k = k * c + _rotate_half(k) * s
    qg = q_rot.float().reshape(B, kv_heads, H // kv_heads, hd)
    v = _flat_rows(tv_pool, page_table).float()
    return _paged_softmax_v(qg, k, v, tv_pool.dtype, positions, scale=scale,
                            softcap=softcap, sliding=sliding)


def paged_latent_split_reference(q_rot, tk_pool, tv_pool, a_k, cos_full, sin_full,
                                 page_table, positions, *, scale, softcap, sliding,
                                 kv_heads, chunk=SPLIT_KEYS):
    """Plain version of the split form: each row's latent rows loaded as
    ``split_boxes`` loads them, chunk by chunk; per chunk and head the max
    m_j of the masked logits, den_j = Σ p and s_j = Σ T(p)·tv with
    p = exp(l − m_j) rounded to the pool's type for s only; then
    out = Σ_j e^(m_j − M)·s_j / Σ_j e^(m_j − M)·den_j over the live chunks,
    M their largest m_j. -> s [B, H, Rv] f32."""
    B, H, hd = q_rot.shape
    KV, rep = kv_heads, H // kv_heads
    P, MP = tk_pool.shape[1], page_table.shape[1]
    Rv = tv_pool.shape[2]
    qg = q_rot.float().reshape(B, KV, rep, hd)
    out = torch.empty((B, H, Rv), dtype=torch.float32, device=q_rot.device)
    for b in range(B):
        pos = int(positions[b])
        t_lo = max(0, pos - sliding + 1) if sliding > 0 else 0
        ms, dens, nums = [], [], []
        for j, boxes in split_boxes(P, MP, pos, sliding, chunk).items():
            tk = torch.cat([tk_pool[int(page_table[b, lp]), r0:r0 + n]
                            for _, n, lp, r0 in boxes]).float()
            tv = torch.cat([tv_pool[int(page_table[b, lp]), r0:r0 + n]
                            for _, n, lp, r0 in boxes]).float()
            t = torch.arange(j * chunk, (j + 1) * chunk, device=q_rot.device)
            rows = t.clamp(max=cos_full.shape[0] - 1)
            k = torch.matmul(tk, a_k.float().t()).reshape(chunk, KV, hd)
            c, s = cos_full[rows].float()[:, None], sin_full[rows].float()[:, None]
            k = k * c + _rotate_half(k) * s
            logits = torch.einsum("grd,tgd->grt", qg[b], k) * scale
            if softcap > 0:
                logits = softcap * torch.tanh(logits / softcap)
            live = (t >= t_lo) & (t <= pos)
            logits = torch.where(live, logits, torch.full_like(logits, -1e30))
            m = logits.amax(dim=-1)                                  # [KV, rep]
            p = torch.exp(logits - m[..., None])
            ms.append(m)
            dens.append(p.sum(dim=-1))
            nums.append(torch.einsum("grt,tv->grv", p.to(tv_pool.dtype).float(), tv))
        m_all = torch.stack(ms)
        w = torch.exp(m_all - m_all.amax(dim=0))
        num = (w[..., None] * torch.stack(nums)).sum(dim=0)
        den = (w * torch.stack(dens)).sum(dim=0)
        out[b] = (num / den[..., None]).reshape(H, Rv)
    return out


def paged_dense_split_reference(q_rot, k_pool, v_pool, page_table, positions, *,
                                scale, softcap, sliding, kv_heads,
                                chunk=DENSE_SPLIT_KEYS):
    """Plain version of kernel 5's split form: per row, per KV group (a
    head's result does not depend on how the kernel groups heads into
    blocks) and per chunk that ``split_boxes`` launches, the chunk's K (and V or tv) rows loaded as its boxes load
    them, then per head the chunk's max m_j of the masked logits,
    den_j = Σ p and s_j = Σ T(p)·V with p = exp(l − m_j) rounded to the
    pool's type for s only; then out = Σ_j e^(m_j − M)·s_j /
    Σ_j e^(m_j − M)·den_j over the live chunks, M their largest m_j.
    -> s [B, H, hd] (dense V) or [B, H, Rv] (V-latent) f32."""
    B, H, hd = q_rot.shape
    KV, rep = kv_heads, H // kv_heads
    P, MP = k_pool.shape[1], page_table.shape[1]
    v_latent = v_pool.dim() == 3
    SV = v_pool.shape[2] if v_latent else hd
    qg = q_rot.float().reshape(B, KV, rep, hd)
    out = torch.empty((B, H, SV), dtype=torch.float32, device=q_rot.device)
    for b in range(B):
        pos = int(positions[b])
        t_lo = max(0, pos - sliding + 1) if sliding > 0 else 0
        boxes = split_boxes(P, MP, pos, sliding, chunk)

        def rows(pool, j):
            return torch.cat([pool[int(page_table[b, lp]), r0:r0 + n]
                              for _, n, lp, r0 in boxes[j]]).float()
        for g in range(KV):
            ms, dens, nums = [], [], []
            for j in boxes:
                k = rows(k_pool, j)[:, g]                            # [chunk, hd]
                t = torch.arange(j * chunk, (j + 1) * chunk, device=q_rot.device)
                logits = torch.einsum("rd,td->rt", qg[b, g], k) * scale
                if softcap > 0:
                    logits = softcap * torch.tanh(logits / softcap)
                live = (t >= t_lo) & (t <= pos)
                logits = torch.where(live, logits, torch.full_like(logits, -1e30))
                m = logits.amax(dim=-1)                              # [rep]
                p = torch.exp(logits - m[..., None])
                pv = p.to(v_pool.dtype).float()
                v = rows(v_pool, j)
                ms.append(m)
                dens.append(p.sum(dim=-1))
                nums.append(pv @ (v if v_latent else v[:, g]))
            m_all = torch.stack(ms)
            w = torch.exp(m_all - m_all.amax(dim=0))
            num = (w[..., None] * torch.stack(nums)).sum(dim=0)
            den = (w * torch.stack(dens)).sum(dim=0)
            out[b, g * rep:(g + 1) * rep] = num / den[..., None]
    return out


def _check(kind, q_rot, kv_heads, pool_dtype, tensors):
    """Device, dtype, shape and contiguity checks of a launch;
    ``tensors`` maps a name to (tensor, shape, dtype)."""
    B, H, hd = q_rot.shape
    if pool_dtype not in _DTYPE_CODES:
        raise TypeError(f"{kind}: pool dtype {pool_dtype} not supported")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{kind}: head_dim {hd} not in {_HEAD_DIMS}")
    if kv_heads <= 0 or H % kv_heads or H // kv_heads > _MAX_REP:
        raise ValueError(f"{kind}: {H} heads over {kv_heads} KV heads")
    for nm, (t, shape, dtype) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kind}: {nm} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != q_rot.device:
            raise ValueError(f"{kind}: {nm} on {t.device}, q on {q_rot.device}")
        if t.dtype != dtype:
            raise TypeError(f"{kind}: {nm} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kind}: {nm} is not contiguous")
        if nm == "k_pool" and t.data_ptr() % 16:   # kernel 5's 16-byte loads
            raise ValueError(f"{kind}: {nm} is not 16-byte aligned")


def _workspace(kind, lib, B, H, KV, width, P, MP, device, *form):
    """The f32 workspace of the chunks' partial sums (the kernels split each
    row's keys over blocks and combine them in a second launch)."""
    fn = getattr(lib, f"{kind}_workspace")
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * (6 + len(form))
    return torch.empty((fn(B, H, KV, width, P, MP, *form),), dtype=torch.float32,
                       device=device)


def _smem_check(kind, lib, hd, rep, width, MP, *form):
    fn = getattr(lib, f"{kind}_smem_bytes")
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * (4 + len(form))
    need = fn(hd, rep, width, MP, *form)
    if need > _MAX_SMEM:
        raise ValueError(f"{kind}: needs {need} bytes of shared memory (rep "
                         f"{rep}, width {width}, {MP} pages a row), over {_MAX_SMEM}")


def _launch_dense(q_rot, k_pool, v_pool, page_table, positions, *, scale,
                  softcap, sliding, kv_heads, form=None):
    kind = "paged_dense_attention"
    B, H, hd = q_rot.shape
    KV = kv_heads
    NP, P = k_pool.shape[:2]
    MP = page_table.shape[1]
    v_latent = v_pool.dim() == 3
    SV = v_pool.shape[2] if v_latent else hd
    dt = k_pool.dtype
    _check(kind, q_rot, KV, dt, {
        "q": (q_rot, (B, H, hd), torch.float32),
        "k_pool": (k_pool, (NP, P, KV, hd), dt),
        "v_pool": (v_pool, (NP, P, SV) if v_latent else (NP, P, KV, hd), dt),
        "page_table": (page_table, (B, MP), torch.int32),
        "positions": (positions, (B,), torch.int32)})
    lib = _build.library(kind)
    form = form or _dense_form(dt, hd, SV, P, all(t.data_ptr() % 16 == 0
                                                 for t in (k_pool, v_pool)))
    code = _DENSE_FORM_CODES[form]
    _smem_check(kind, lib, hd, H // KV, SV, MP, code)
    ws = _workspace(kind, lib, B, H, KV, SV, P, MP, q_rot.device, code)
    fn = lib.paged_dense_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    out = torch.empty((B, H, SV), dtype=torch.float32, device=q_rot.device)
    with torch.cuda.device(q_rot.device):
        stream = torch.cuda.current_stream(q_rot.device).cuda_stream
        err = fn(q_rot.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 page_table.data_ptr(), positions.data_ptr(), ws.data_ptr(), out.data_ptr(),
                 B, H, KV, hd, NP, P, MP, SV, int(v_latent), code, float(scale),
                 float(softcap), int(sliding), _DTYPE_CODES[dt], stream)
    _build.check(lib, kind, err)
    counter = paged_dense_decode_attention
    counter.launches += 1
    counter.last_form = form
    counter.form_launches[form] = counter.form_launches.get(form, 0) + 1
    return out


def _launch_latent(q_rot, tk_pool, tv_pool, a_k, cos_full, sin_full, page_table,
                   positions, *, scale, softcap, sliding, kv_heads, form=None):
    kind = "paged_latent_attention"
    B, H, hd = q_rot.shape
    KV = kv_heads
    NP, P, Rk = tk_pool.shape
    Rv = tv_pool.shape[2]
    MP = page_table.shape[1]
    dt = tk_pool.dtype
    _check(kind, q_rot, KV, dt, {
        "q": (q_rot, (B, H, hd), torch.float32),
        "tk_pool": (tk_pool, (NP, P, Rk), dt),
        "tv_pool": (tv_pool, (NP, P, Rv), dt),
        "a_k": (a_k, (KV * hd, Rk), dt),
        "cos": (cos_full, (MP * P, hd), torch.float32),
        "sin": (sin_full, (MP * P, hd), torch.float32),
        "page_table": (page_table, (B, MP), torch.int32),
        "positions": (positions, (B,), torch.int32)})
    lib = _build.library(kind)
    form = form or _latent_form(dt, hd, Rk, Rv, P, all(
        t.data_ptr() % 16 == 0 for t in (tk_pool, tv_pool, a_k)))
    _smem_check(kind, lib, hd, H // KV, Rv, MP, _FORM_CODES[form])
    ws = _workspace(kind, lib, B, H, KV, Rv, P, MP, q_rot.device)
    fn = lib.paged_latent_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out = torch.empty((B, H, Rv), dtype=torch.float32, device=q_rot.device)
    with torch.cuda.device(q_rot.device):
        stream = torch.cuda.current_stream(q_rot.device).cuda_stream
        err = fn(q_rot.data_ptr(), tk_pool.data_ptr(), tv_pool.data_ptr(),
                 a_k.data_ptr(), cos_full.data_ptr(), sin_full.data_ptr(),
                 page_table.data_ptr(), positions.data_ptr(), ws.data_ptr(),
                 out.data_ptr(),
                 B, H, KV, hd, NP, P, MP, Rk, Rv, float(scale), float(softcap),
                 int(sliding), _DTYPE_CODES[dt], _FORM_CODES[form], stream)
    _build.check(lib, kind, err)
    counter = paged_latent_decode_attention
    counter.launches += 1
    counter.last_form = form
    counter.form_launches[form] = counter.form_launches.get(form, 0) + 1
    return out


def _paged_dense_core(q_rot, k_pool, v_pool, page_table, positions, *, scale,
                      softcap, sliding, kv_heads, form=None):
    """q_rot [B, H, hd] (f32 on a CUDA tensor); k_pool [NP, P, KV, hd]
    (rotated at write time); v_pool [NP, P, KV, hd] or [NP, P, Rv];
    page_table [B, MP], positions [B] int32 -> [B, H, hd] or [B, H, Rv] f32.
    `form` (measurements only) runs a named kernel form instead of the one
    `_dense_form` picks; the launcher refuses one the shape does not
    allow."""
    kw = dict(scale=scale, softcap=softcap, sliding=sliding, kv_heads=kv_heads)
    if q_rot.device.type == "cuda":
        return _launch_dense(q_rot, k_pool, v_pool, page_table, positions, form=form, **kw)
    if q_rot.device.type == "cpu":
        return paged_dense_reference(q_rot, k_pool, v_pool, page_table,
                                     positions, **kw)
    raise ValueError(f"paged_dense_attention: no kernel for device {q_rot.device}")


def _paged_latent_core(q_rot, tk_pool, tv_pool, a_k, cos_full, sin_full,
                       page_table, positions, *, scale, softcap, sliding,
                       kv_heads, form=None):
    """q_rot [B, H, hd] (f32 on a CUDA tensor); tk_pool [NP, P, Rk];
    tv_pool [NP, P, Rv]; a_k [KV*hd, Rk]; cos/sin [MP*P, hd] f32;
    page_table [B, MP], positions [B] int32 -> s [B, H, Rv] f32.
    `form` (measurements only) runs a named kernel form instead of the one
    `_latent_form` picks; the launcher refuses one the shape does not
    allow."""
    kw = dict(scale=scale, softcap=softcap, sliding=sliding, kv_heads=kv_heads)
    if q_rot.device.type == "cuda":
        return _launch_latent(q_rot, tk_pool, tv_pool, a_k, cos_full, sin_full,
                              page_table, positions, form=form, **kw)
    if q_rot.device.type == "cpu":
        return paged_latent_reference(q_rot, tk_pool, tv_pool, a_k, cos_full,
                                      sin_full, page_table, positions, **kw)
    raise ValueError(f"paged_latent_attention: no kernel for device {q_rot.device}")


def _up_project_v(s, a_v, v_bias, KV, hd):
    """s [B, H, Rv] -> out [B, H*hd]: the per-group A_v up-projection (never
    materializing the repeated A_v) plus the v bias, in f32."""
    B, H, Rv = s.shape
    a_v3 = a_v.float().reshape(KV, hd, Rv)
    out = torch.einsum("bgrv,gdv->bgrd", s.reshape(B, KV, H // KV, Rv), a_v3)
    if v_bias is not None:
        out = out + v_bias.float().reshape(KV, hd)[None, :, None, :]
    return out.reshape(B, H * hd)


def _rows(page_table, positions, device):
    return (torch.as_tensor(page_table, device=device).to(torch.int32).contiguous(),
            torch.as_tensor(positions, device=device).to(torch.int32).contiguous())


def paged_dense_decode_attention(q_rot, k_pool, v_pool, page_table, positions,
                                 *, kv_heads, scale, softcap=0.0, sliding=0,
                                 a_v: Optional[torch.Tensor] = None,
                                 v_bias: Optional[torch.Tensor] = None):
    """Paged flash-decoding with dense K pages. With dense V pages returns
    [B, H*hd] f32 (+ the v bias per group: softmax weights sum to 1); with
    V-latent pages (``a_v`` given) the numerator is up-projected per KV group
    as in the latent path."""
    B, H, hd = q_rot.shape
    KV = kv_heads
    pt, pos = _rows(page_table, positions, q_rot.device)
    out = _paged_dense_core(q_rot.float().contiguous(), k_pool, v_pool, pt, pos,
                            scale=scale, softcap=softcap, sliding=sliding,
                            kv_heads=KV)
    if v_pool.dim() == 4:
        if v_bias is not None:
            out = (out.reshape(B, KV, H // KV, hd)
                   + v_bias.float().reshape(KV, hd)[None, :, None, :])
        return out.reshape(B, H * hd)
    return _up_project_v(out, a_v, v_bias, KV, hd)


def paged_latent_decode_attention(q_rot, tk_pool, tv_pool, a_k, a_v, cos_full,
                                  sin_full, page_table, positions, *, kv_heads,
                                  scale, softcap=0.0, sliding=0,
                                  v_bias: Optional[torch.Tensor] = None):
    """Paged counterpart of latent_decode_attention: latents live in page
    pools indexed through ``page_table``, positions are per sequence
    (ragged). Returns the attention output [B, H*hd] f32 (pre-o_proj).
    A bf16 A_k over f32 pools is widened to f32, which is exact; on a CUDA
    tensor an A_k wider than the pools raises."""
    B, H, hd = q_rot.shape
    KV = kv_heads
    pt, pos = _rows(page_table, positions, q_rot.device)
    T = pt.shape[1] * tk_pool.shape[1]
    if a_k.dtype != tk_pool.dtype and tk_pool.dtype == torch.float32:
        a_k = a_k.float()
    s = _paged_latent_core(
        q_rot.float().contiguous(), tk_pool, tv_pool, a_k.contiguous(),
        cos_full[:T].float().contiguous(), sin_full[:T].float().contiguous(),
        pt, pos, scale=scale, softcap=softcap, sliding=sliding, kv_heads=KV)
    return _up_project_v(s, a_v, v_bias, KV, hd)


# launches of the CUDA kernels in this process (the plain versions do not
# count), the form of the last launch and the launches by form
paged_dense_decode_attention.launches = 0
paged_dense_decode_attention.last_form = None
paged_dense_decode_attention.form_launches = {}
paged_latent_decode_attention.launches = 0
paged_latent_decode_attention.last_form = None
paged_latent_decode_attention.form_launches = {}
