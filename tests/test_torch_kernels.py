"""The port's two kernels: their plain PyTorch versions (what a CPU tensor
takes) vs the JAX package's Pallas kernels run in interpret mode. The CUDA
kernels themselves are held against these plain versions on a card by
tests/test_torch_cuda.py.

Tolerances: f32 atol/rtol 1e-5 for kernel 1 (two f32-accumulated products)
and 1e-4 for kernel 2 (as the JAX package's own kernel tests, which sum the
softmax in another order); bf16 outputs within 2e-2 (one bf16 rounding of
the output, half an ulp is 4e-3 relative, plus the rounding of t or p
before the second product).
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from asvd4llm_tpu.models.decoder import rope_cos_sin  # noqa: E402
from asvd4llm_tpu.ops.pallas_latent_attention import (  # noqa: E402
    latent_decode_attention as j_latent,
)
from asvd4llm_tpu.ops.pallas_lowrank import fused_lowrank_apply as j_fused  # noqa: E402
from asvd4llm_tpu_torch.ops import fused_lowrank as fl  # noqa: E402
from asvd4llm_tpu_torch.ops import latent_attention as la  # noqa: E402


def _t(a, dtype):
    """numpy f32 -> torch tensor of `dtype` (bf16 via rounding)."""
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _lowrank_inputs(seed, lead, K, N, R, bias=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, K).astype(np.float32)
    a = (rng.randn(N, R) * R ** -0.5).astype(np.float32)
    b = (rng.randn(R, K) * K ** -0.5).astype(np.float32)
    bias_ = (rng.randn(N) * 0.5).astype(np.float32) if bias else None
    return x, a, b, bias_


@pytest.mark.parametrize("lead,K,N,R,bias", [
    ((4,), 256, 512, 64, True),        # decode-ish
    ((3,), 300, 200, 50, True),        # nothing aligned
    ((1,), 129, 67, 5, False),         # odd everything, no bias
    ((2, 5), 192, 256, 32, False),     # 3-D input
])
def test_fused_lowrank_plain_matches_pallas(lead, K, N, R, bias):
    x, a, b, bias_ = _lowrank_inputs(0, lead, K, N, R, bias)
    ref = np.asarray(j_fused(*(None if v is None else jnp.asarray(v)
                               for v in (x, a, b, bias_)), interpret=True))
    out = fl.fused_lowrank_apply(*(None if v is None else _t(v, torch.float32)
                                   for v in (x, a, b, bias_)))
    assert out.shape == (*lead, N)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_fused_lowrank_plain_matches_pallas_bf16():
    x, a, b, bias_ = _lowrank_inputs(1, (8,), 256, 128, 32)
    ref = np.asarray(j_fused(*(_j(v, jnp.bfloat16) for v in (x, a, b, bias_)),
                             interpret=True)).astype(np.float32)
    out = fl.fused_lowrank_apply(*(_t(v, torch.bfloat16) for v in (x, a, b, bias_)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_fused_lowrank_large_m_is_two_matmuls():
    """Above MAX_FUSED_TOKENS the op is the plain two-matmul path (the JAX
    wrapper hands those shapes to XLA)."""
    from asvd4llm_tpu_torch.ops.lowrank import lowrank_apply
    x, a, b, bias_ = _lowrank_inputs(2, (40,), 64, 48, 8)
    args = [_t(v, torch.float32) for v in (x, a, b, bias_)]
    out = fl.fused_lowrank_apply(*args, max_tokens=16)
    np.testing.assert_array_equal(out.numpy(), lowrank_apply(*args).numpy())


def _latent_inputs(seed, B, H, KV, hd, T, Rk, Rv):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, hd).astype(np.float32)
    tk = (rng.randn(B, T, Rk) * 0.3).astype(np.float32)
    tv = (rng.randn(B, T, Rv) * 0.3).astype(np.float32)
    a_k = (rng.randn(KV * hd, Rk) * 0.2).astype(np.float32)
    a_v = (rng.randn(KV * hd, Rv) * 0.2).astype(np.float32)
    vb = (rng.randn(KV * hd) * 0.1).astype(np.float32)
    cos, sin = (np.asarray(c) for c in rope_cos_sin(jnp.arange(T), hd, 10000.0))
    return q, tk, tv, a_k, a_v, vb, cos, sin


LATENT_CASES = {
    # name: (B, H, KV, hd, T, Rk, Rv, pos, softcap, sliding, v_bias)
    "mha": (2, 4, 4, 16, 64, 24, 20, 63, 0.0, 0, False),
    "gqa2_mid": (2, 4, 2, 16, 64, 24, 20, 30, 0.0, 0, False),
    "gqa4_softcap": (1, 8, 2, 16, 64, 16, 12, 40, 30.0, 0, False),
    "sliding_vbias": (2, 4, 2, 16, 64, 24, 20, 50, 0.0, 16, True),
    "t_not_tile_multiple": (2, 4, 4, 16, 48, 24, 20, 40, 0.0, 0, True),
}


@pytest.mark.parametrize("case", sorted(LATENT_CASES))
def test_latent_attention_plain_matches_pallas(case):
    B, H, KV, hd, T, Rk, Rv, pos, cap, sw, use_vb = LATENT_CASES[case]
    q, tk, tv, a_k, a_v, vb, cos, sin = _latent_inputs(3, B, H, KV, hd, T, Rk, Rv)
    kw = dict(kv_heads=KV, scale=hd ** -0.5, softcap=cap, sliding=sw)
    ref = np.asarray(j_latent(
        *(jnp.asarray(v) for v in (q, tk, tv, a_k, a_v, cos, sin)), pos,
        v_bias=jnp.asarray(vb) if use_vb else None, tt=32, interpret=True, **kw))
    out = la.latent_decode_attention(
        *(_t(v, torch.float32) for v in (q, tk, tv, a_k, a_v, cos, sin)), pos,
        v_bias=_t(vb, torch.float32) if use_vb else None, **kw)
    assert out.shape == (B, H * hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_latent_attention_plain_matches_pallas_bf16():
    B, H, KV, hd, T, Rk, Rv, pos = 2, 4, 2, 16, 64, 24, 20, 45
    q, tk, tv, a_k, a_v, _, cos, sin = _latent_inputs(4, B, H, KV, hd, T, Rk, Rv)
    kw = dict(kv_heads=KV, scale=hd ** -0.5)
    ref = np.asarray(j_latent(*(_j(v, jnp.bfloat16) for v in (q, tk, tv, a_k, a_v)),
                              jnp.asarray(cos), jnp.asarray(sin), pos, tt=32,
                              interpret=True, **kw)).astype(np.float32)
    out = la.latent_decode_attention(
        *(_t(v, torch.bfloat16) for v in (q, tk, tv, a_k, a_v)),
        _t(cos, torch.float32), _t(sin, torch.float32), pos, **kw)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)
