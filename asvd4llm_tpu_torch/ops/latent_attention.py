"""Fused latent-KV decode attention (flash-decoding over rank-dim latents) —
kernel 2.

Port of asvd4llm_tpu/ops/pallas_latent_attention.py::_latent_attention_core
(public wrapper ``latent_decode_attention``). For a layer whose k/v
projections are low-rank, one decode step reads the latent caches
tk [B,T,Rk] and tv [B,T,Rv] once and computes, per query head h of KV
group g(h):

  K     = tk · A_kᵀ (f32), rotate-half RoPE with f32 cos/sin
  p     = softmax-numerator over keys of scale·q·K (+ softcap, causal and
          sliding mask with -1e30), taken online over T tiles
  s_h   = Σ_t p_t (rounded to tv's dtype) · tv_t   / Σ_t p_t
  out_h = s_h · A_v[g(h)]ᵀ + b_v                 (in this wrapper)

The kernel (``csrc/latent_attention.cu``) produces s [B,H,Rv] f32 on a CUDA
tensor; ``latent_attention_reference`` is its plain PyTorch version with the
same casts, and a CPU tensor takes it. ``_form`` names, from the shape,
the form of the kernel a call runs; ``latent_attention_split_reference`` is
the plain version of what the "split_wgmma" form computes (per-chunk max,
denominator and numerator, then their combination). Restrictions, as in the
JAX kernel: rope positional encoding and no k-projection bias (the caller
checks).

The position ``pos`` is an int or a 0-d int32 tensor on the inputs'
device. The kernel reads it from device memory, as the JAX kernel reads it
from SMEM, and its grid depends on shapes only, so a CUDA graph that
captured a decode step replays it at each new position
(utils/graphs.py). An int is checked against the cache and moved to the
device once per call.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from asvd4llm_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448          # opt-in shared memory of one Hopper block
_HEAD_DIMS = (32, 64, 128, 256)
_MAX_REP = 16
SPLIT_KEYS = 128            # keys per block of the split form (kChunk in the source)
_SPLIT_HEAD_DIMS = (64, 128)
_FORM_CODES = {"tile32": 0, "split_wgmma": 1}


def _form(dtype: torch.dtype, hd: int, Rk: int, Rv: int, aligned: bool = True) -> str:
    """The kernel form a call of kernel 2 runs: "split_wgmma" (bf16, head
    dim 64 or 128, Rk and Rv multiples of 8, 16-byte aligned caches and
    A_k), else "tile32" (the one-block-per-row form)."""
    if (dtype == torch.bfloat16 and hd in _SPLIT_HEAD_DIMS and Rk % 8 == 0
            and Rv % 8 == 0 and aligned):
        return "split_wgmma"
    return "tile32"


def _rotate_half(k: torch.Tensor) -> torch.Tensor:
    half = k.shape[-1] // 2
    return torch.cat([-k[..., half:], k[..., :half]], dim=-1)


def _masked_logits(q_rot, tk, a_k, cos_full, sin_full, pos, *, scale, softcap,
                   sliding, kv_heads):
    """-> (logits [B, KV, rep, T] f32 with masked keys at -1e30, the keys'
    mask [T]): K = RoPE(tk·A_kᵀ) in f32, l = scale·q·K (+ softcap)."""
    B, H, hd = q_rot.shape
    T = tk.shape[1]
    KV = kv_heads
    k = torch.matmul(tk.float(), a_k.float().t()).reshape(B, T, KV, hd)
    c = cos_full.float()[None, :, None, :]
    s = sin_full.float()[None, :, None, :]
    k = k * c + _rotate_half(k) * s
    qg = q_rot.float().reshape(B, KV, H // KV, hd)
    logits = torch.einsum("bgrd,btgd->bgrt", qg, k) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    k_pos = torch.arange(T, device=tk.device)
    allow = k_pos <= pos
    if sliding > 0:
        allow &= k_pos > pos - sliding
    return torch.where(allow, logits, torch.full_like(logits, -1e30)), allow


def latent_attention_reference(q_rot, tk, tv, a_k, cos_full, sin_full, pos, *,
                               scale, softcap, sliding, kv_heads):
    """Plain version of the kernel: -> s [B, H, Rv] f32."""
    logits, _ = _masked_logits(q_rot, tk, a_k, cos_full, sin_full, pos, scale=scale,
                               softcap=softcap, sliding=sliding, kv_heads=kv_heads)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    den = p.sum(dim=-1)                                       # [B, KV, rep]
    num = torch.einsum("bgrt,btv->bgrv", p.to(tv.dtype).float(), tv.float())
    return (num / den[..., None]).reshape(q_rot.shape[0], q_rot.shape[1], -1)


def latent_attention_split_reference(q_rot, tk, tv, a_k, cos_full, sin_full, pos, *,
                                     scale, softcap, sliding, kv_heads,
                                     chunk=SPLIT_KEYS):
    """Plain version of the split form: keys cut into chunks of `chunk`;
    per chunk and head the max m_j of the masked logits, den_j = Σ p and
    s_j = Σ T(p)·tv with p = exp(l − m_j) rounded to tv's type for s only;
    then out = Σ_j e^(m_j − M)·s_j / Σ_j e^(m_j − M)·den_j over the chunks
    with den_j > 0, M their largest m_j. Every chunk of T is visited, as
    the kernel launches them all; a chunk with no live key has den = 0 and
    drops out. -> s [B, H, Rv] f32."""
    T = tk.shape[1]
    logits, allow = _masked_logits(q_rot, tk, a_k, cos_full, sin_full, pos, scale=scale,
                                   softcap=softcap, sliding=sliding, kv_heads=kv_heads)
    ms, dens, nums = [], [], []
    for j in range(-(-T // chunk)):
        sl = slice(j * chunk, min(T, (j + 1) * chunk))
        m = logits[..., sl].amax(dim=-1)                      # [B, KV, rep]
        p = torch.exp(logits[..., sl] - m[..., None])
        dens.append(p.sum(dim=-1) if allow[sl].any() else torch.zeros_like(m))
        nums.append(torch.einsum("bgrt,btv->bgrv", p.to(tv.dtype).float(),
                                 tv[:, sl].float()))
        ms.append(m)
    m_all, den_all = torch.stack(ms), torch.stack(dens)     # [NS, B, KV, rep]
    live = den_all > 0
    big = torch.where(live, m_all, torch.full_like(m_all, -1e30)).amax(dim=0)
    w = torch.where(live, torch.exp(m_all - big), torch.zeros_like(m_all))
    num = (w[..., None] * torch.stack(nums)).sum(dim=0)
    den = (w * den_all).sum(dim=0)
    return (num / den[..., None]).reshape(q_rot.shape[0], q_rot.shape[1], -1)


def device_position(pos, T: int, device) -> torch.Tensor:
    """``pos`` as a 0-d int32 tensor on ``device``: an int is checked against
    a cache of T and moved once; a tensor is taken as it is (its value is
    never read on the host, so it may live in a buffer a CUDA graph
    advances)."""
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1 or pos.dtype != torch.int32 or pos.device != device:
            raise ValueError(f"latent_attention: position tensor {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}, expected one "
                             f"int32 on {device}")
        return pos.reshape(())
    if not 0 <= int(pos) < T:
        raise ValueError(f"latent_attention: position {pos} outside cache of {T}")
    return torch.tensor(int(pos), dtype=torch.int32, device=device)


def _launch(q_rot, tk, tv, a_k, cos_full, sin_full, pos, *, scale, softcap,
            sliding, kv_heads, form=None):
    B, H, hd = q_rot.shape
    T, Rk = tk.shape[1], tk.shape[2]
    Rv = tv.shape[2]
    KV = kv_heads
    if q_rot.dtype not in _DTYPE_CODES:
        raise TypeError(f"latent_attention: dtype {q_rot.dtype} not supported")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"latent_attention: head_dim {hd} not in {_HEAD_DIMS}")
    if H % KV or H // KV > _MAX_REP:
        raise ValueError(f"latent_attention: {H} heads over {KV} KV heads")
    pos = device_position(pos, T, q_rot.device)
    shapes = {"tk": (tk, (B, T, Rk)), "tv": (tv, (B, T, Rv)),
              "a_k": (a_k, (KV * hd, Rk)), "cos": (cos_full, (T, hd)),
              "sin": (sin_full, (T, hd)), "q": (q_rot, (B, H, hd))}
    for nm, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"latent_attention: {nm} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != q_rot.device:
            raise ValueError(f"latent_attention: {nm} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"latent_attention: {nm} is not contiguous")
        want = torch.float32 if nm in ("cos", "sin") else q_rot.dtype
        if t.dtype != want:
            raise TypeError(f"latent_attention: {nm} is {t.dtype}, expected {want}")
    lib = _build.library("latent_attention")
    form = form or _form(q_rot.dtype, hd, Rk, Rv,
                         all(t.data_ptr() % 16 == 0 for t in (tk, tv, a_k)))
    if form == "tile32":
        smem = lib.latent_attention_smem_bytes
        smem.restype = ctypes.c_longlong
        smem.argtypes = [ctypes.c_int] * 3
        need = smem(hd, H // KV, Rv)
        if need > _MAX_SMEM:
            raise ValueError(f"latent_attention: needs {need} bytes of shared "
                             f"memory (rep {H // KV}, Rv {Rv}), over {_MAX_SMEM}")
        ws, ns = None, 0
    else:   # per-chunk max, denominator and numerator of every head, every chunk
        ns = -(-T // SPLIT_KEYS)
        ws = torch.empty((B * H * ns * (Rv + 2),), dtype=torch.float32,
                         device=q_rot.device)
    fn = lib.latent_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    out = torch.empty((B, H, Rv), dtype=torch.float32, device=q_rot.device)
    with torch.cuda.device(q_rot.device):
        stream = torch.cuda.current_stream(q_rot.device).cuda_stream
        err = fn(q_rot.data_ptr(), tk.data_ptr(), tv.data_ptr(), a_k.data_ptr(),
                 cos_full.data_ptr(), sin_full.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(), ns,
                 B, H, KV, hd, T, Rk, Rv, float(scale),
                 float(softcap), int(sliding), _DTYPE_CODES[q_rot.dtype],
                 _FORM_CODES[form], stream)
    _build.check(lib, "latent_attention", err)
    latent_decode_attention.launches += 1
    latent_decode_attention.last_form = form
    by_form = latent_decode_attention.form_launches
    by_form[form] = by_form.get(form, 0) + 1
    return out


def _latent_attention_core(q_rot, tk, tv, a_k, cos_full, sin_full, pos, *,
                           scale, softcap, sliding, kv_heads, form=None):
    """q_rot [B, H, hd] (already rotated), tk [B, T, Rk], tv [B, T, Rv],
    a_k [KV*hd, Rk], cos/sin [T, hd] f32, pos an int or a 0-d int32 tensor
    -> s_norm [B, H, Rv] f32.
    `form` (measurements only) runs a named kernel form instead of the one
    `_form` picks; the launcher refuses one the shape does not allow."""
    kw = dict(scale=scale, softcap=softcap, sliding=sliding, kv_heads=kv_heads)
    if q_rot.device.type == "cuda":
        return _launch(q_rot, tk, tv, a_k, cos_full, sin_full, pos, form=form, **kw)
    if q_rot.device.type == "cpu":
        return latent_attention_reference(q_rot, tk, tv, a_k, cos_full,
                                          sin_full, pos, **kw)
    raise ValueError(f"latent_attention: no kernel for device {q_rot.device}")


def latent_decode_attention(q_rot, tk, tv, a_k, a_v, cos_full, sin_full, pos,
                            *, kv_heads, scale, softcap=0.0, sliding=0,
                            v_bias: Optional[torch.Tensor] = None):
    """Fused latent attention for one decode step.

    q_rot [B, H, hd] rotated query; tk/tv [B, T, R*] latent caches;
    a_k [KV*hd, Rk], a_v [KV*hd, Rv] (the low-rank A factors); pos: the
    query's position, an int or a 0-d int32 tensor on the device. Returns
    the attention output [B, H*hd] f32 (pre-o_proj). Keys at or past T never enter, which equals the JAX
    wrapper's zero padding of T to its tile."""
    B, H, hd = q_rot.shape
    KV = kv_heads
    rep = H // KV
    Rv = tv.shape[2]
    s_norm = _latent_attention_core(
        q_rot.contiguous(), tk, tv, a_k, cos_full.float().contiguous(),
        sin_full.float().contiguous(), pos, scale=scale, softcap=softcap,
        sliding=sliding, kv_heads=KV)                        # [B, H, Rv]
    # V up-projection per KV group, never materializing the repeated A_v
    a_v3 = a_v.float().reshape(KV, hd, Rv)
    out = torch.einsum("bgrv,gdv->bgrd", s_norm.reshape(B, KV, rep, Rv), a_v3)
    if v_bias is not None:
        out = out + v_bias.float().reshape(KV, hd)[None, :, None, :]
    return out.reshape(B, H * hd)


# launches of the CUDA kernel in this process (the plain version does not
# count), the form of the last launch, and the launches by form
latent_decode_attention.launches = 0
latent_decode_attention.last_form = None
latent_decode_attention.form_launches = {}
