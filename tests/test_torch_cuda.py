"""The port's CUDA kernels on a card, each held against its plain PyTorch
version on the same inputs, with its launch counter. Every test here is
marked `gpu` and skips without a card; on one, run

    python -m pytest tests/test_torch_cuda.py -q -m gpu

This file imports torch and numpy only, so it runs where JAX is absent.

Tolerances: float32 atol/rtol 1e-4 (the kernels sum in another order, with
split-K atomics); bfloat16 2e-2 (one rounding of the output, half an ulp is
4e-3 relative, plus the rounding of t or p before the second product).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from asvd4llm_tpu_torch.ops import fused_lowrank as fl  # noqa: E402
from asvd4llm_tpu_torch.ops import latent_attention as la  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _randn(rng, *shape, scale=1.0):
    return rng.randn(*shape).astype(np.float32) * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,R,bias", [
    (1, 4096, 4096, 1920, True),      # Llama-2-7B q_proj at ratio 0.9
    (4, 11008, 4096, 2688, False),    # down_proj, decode batch 4
    (3, 300, 200, 50, True),          # K and R not multiples of 8
    (4, 129, 67, 5, False),           # odd everything
    (16, 256, 512, 64, True),         # the largest decode-path M
    (17, 256, 130, 40, True),         # the smallest tiled-path M
    (200, 512, 300, 96, False),
    (5, 264, 100, 24, True),          # K, N, R multiples of 8 but not of the tiles
    (70, 264, 100, 24, False),
    (1024, 512, 256, 128, True),      # the largest fused M
])
@pytest.mark.parametrize("x_offset", [0, 1])
def test_fused_lowrank_kernel_matches_plain(cuda, dtype, M, K, N, R, bias, x_offset):
    """x_offset 1 starts x one element past a 16-byte boundary, which sends
    the bf16 products from the tensor cores to the CUDA-core forms."""
    rng = np.random.RandomState(M + K)
    dt = getattr(torch, dtype)
    x_vals = torch.from_numpy(_randn(rng, M, K)).to(cuda, dt)
    x = torch.empty(M * K + x_offset, dtype=dt, device=cuda)[x_offset:].view(M, K)
    x.copy_(x_vals)
    a = torch.from_numpy(_randn(rng, N, R, scale=R ** -0.5)).to(cuda, dt)
    b = torch.from_numpy(_randn(rng, R, K, scale=K ** -0.5)).to(cuda, dt)
    bv = torch.from_numpy(_randn(rng, N, scale=0.1)).to(cuda, dt) if bias else None
    n0 = fl.fused_lowrank_apply.launches
    out = fl.fused_lowrank_apply(x, a, b, bv)
    torch.cuda.synchronize()
    assert fl.fused_lowrank_apply.launches == n0 + 1
    assert out.dtype == dt and out.shape == (M, N)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), fl.fused_lowrank_reference(x, a, b, bv).float(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
def test_fused_lowrank_large_m_and_bad_inputs(cuda):
    """Above MAX_FUSED_TOKENS the op is two plain matmuls (no launch); an
    input the kernel does not take raises instead of falling back."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(_randn(rng, 40, 64)).to(cuda)
    a = torch.from_numpy(_randn(rng, 48, 8)).to(cuda)
    b = torch.from_numpy(_randn(rng, 8, 64)).to(cuda)
    n0 = fl.fused_lowrank_apply.launches
    fl.fused_lowrank_apply(x, a, b, None, max_tokens=16)
    assert fl.fused_lowrank_apply.launches == n0
    with pytest.raises(ValueError, match="contiguous"):
        fl.fused_lowrank_apply(x, a.t().contiguous().t(), b, None)
    with pytest.raises(TypeError):
        fl.fused_lowrank_apply(x, a.to(torch.bfloat16), b, None)
    with pytest.raises(TypeError):
        fl.fused_lowrank_apply(x.half(), a.half(), b.half(), None)


# The tiled form's edges: M across its 64- and 128-row tiles, N and R not
# multiples of the output tiles (128, 192 or 256 wide), the last a
# Llama-2-7B linear at the PPL eval's M.
WGMMA_SHAPES = [  # (M, K, N, R)
    (17, 256, 130, 40), (63, 320, 200, 72), (64, 512, 136, 200), (65, 264, 300, 24),
    (127, 512, 1000, 136), (128, 1024, 520, 264), (129, 4096, 4100, 1928),
    (512, 1024, 1032, 648), (1000, 4096, 11008, 2688), (1024, 4096, 4096, 1920),
]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,R", WGMMA_SHAPES)
@pytest.mark.parametrize("bias", [True, False])
def test_fused_lowrank_wgmma_form_edges(cuda, M, K, N, R, bias):
    rng = np.random.RandomState(M + N)
    x = torch.from_numpy(_randn(rng, M, K)).to(cuda, torch.bfloat16)
    a = torch.from_numpy(_randn(rng, N, R, scale=R ** -0.5)).to(cuda, torch.bfloat16)
    b = torch.from_numpy(_randn(rng, R, K, scale=K ** -0.5)).to(cuda, torch.bfloat16)
    bv = torch.from_numpy(_randn(rng, N, scale=0.1)).to(cuda, torch.bfloat16) if bias else None
    assert fl._form(M, K, R, torch.bfloat16) == "wgmma_tiled"
    n0 = fl.fused_lowrank_apply.launches
    out = fl.fused_lowrank_apply(x, a, b, bv)
    torch.cuda.synchronize()
    assert fl.fused_lowrank_apply.launches == n0 + 1
    assert fl.fused_lowrank_apply.last_form == "wgmma_tiled"
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    tol = TOL["bfloat16"]
    torch.testing.assert_close(out.float(), fl.fused_lowrank_reference(x, a, b, bv).float(),
                               atol=tol, rtol=tol)


# Ranks that are not multiples of 8 above M=16: A's rows are not 16-byte
# aligned, so a call with such factors as they are takes the WMMA form;
# the same factors zero-padded by pad_rank (as align_ranks pads a model's)
# take the wgmma form and give the same y. The last two are the KV-target
# run's k/v ranks at Llama-2-7B width, at the PPL eval's M.
UNALIGNED_RANK_SHAPES = [  # (M, K, N, R)
    (17, 256, 130, 37), (100, 512, 300, 50), (129, 1024, 520, 203),
    (1024, 4096, 4096, 819), (1024, 4096, 4096, 409),
]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,R", UNALIGNED_RANK_SHAPES)
def test_fused_lowrank_unaligned_rank_forms(cuda, M, K, N, R):
    from asvd4llm_tpu_torch.ops.lowrank import pad_rank
    rng = np.random.RandomState(M + R)
    x = torch.from_numpy(_randn(rng, M, K)).to(cuda, torch.bfloat16)
    a = torch.from_numpy(_randn(rng, N, R, scale=R ** -0.5)).to(cuda, torch.bfloat16)
    b = torch.from_numpy(_randn(rng, R, K, scale=K ** -0.5)).to(cuda, torch.bfloat16)
    bv = torch.from_numpy(_randn(rng, N, scale=0.1)).to(cuda, torch.bfloat16)
    ref = fl.fused_lowrank_reference(x, a, b, bv).float()
    pad = pad_rank({"A": a, "B": b, "b": bv})
    tol = TOL["bfloat16"]
    for leaf, form in (({"A": a, "B": b}, "wmma_tiled"), (pad, "wgmma_tiled")):
        assert fl._form(M, K, leaf["A"].shape[1], torch.bfloat16) == form
        n0 = fl.fused_lowrank_apply.launches
        out = fl.fused_lowrank_apply(x, leaf["A"], leaf["B"], bv)
        torch.cuda.synchronize()
        assert fl.fused_lowrank_apply.launches == n0 + 1
        assert fl.fused_lowrank_apply.last_form == form
        torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)


LATENT_CASES = {
    # name: (B, H, KV, hd, T, Rk, Rv, pos, softcap, sliding)
    "mha_full": (2, 8, 8, 128, 96, 200, 160, 95, 0.0, 0),
    "gqa4_mid": (2, 16, 4, 128, 80, 96, 72, 50, 0.0, 0),
    "softcap_hd64": (1, 8, 2, 64, 70, 48, 40, 69, 20.0, 0),
    "sliding_hd256": (2, 4, 2, 256, 100, 64, 33, 90, 0.0, 33),
    "t_not_tile_multiple": (3, 4, 4, 128, 45, 37, 29, 44, 0.0, 0),
    "rep16": (1, 16, 1, 64, 64, 32, 24, 63, 0.0, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(LATENT_CASES))
def test_latent_attention_kernel_matches_plain(cuda, dtype, case):
    B, H, KV, hd, T, Rk, Rv, pos, cap, sw = LATENT_CASES[case]
    rng = np.random.RandomState(len(case))
    dt = getattr(torch, dtype)
    q = torch.from_numpy(_randn(rng, B, H, hd)).to(cuda, dt)
    tk = torch.from_numpy(_randn(rng, B, T, Rk, scale=0.3)).to(cuda, dt)
    tv = torch.from_numpy(_randn(rng, B, T, Rv, scale=0.3)).to(cuda, dt)
    a_k = torch.from_numpy(_randn(rng, KV * hd, Rk, scale=Rk ** -0.5)).to(cuda, dt)
    inv = 1.0 / (10000.0 ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    fr = np.arange(T, dtype=np.float32)[:, None] * inv[None, :]
    emb = np.concatenate([fr, fr], axis=-1)
    cos = torch.from_numpy(np.cos(emb)).to(cuda)
    sin = torch.from_numpy(np.sin(emb)).to(cuda)
    kw = dict(scale=hd ** -0.5, softcap=cap, sliding=sw, kv_heads=KV)
    n0 = la.latent_decode_attention.launches
    out = la._latent_attention_core(q, tk, tv, a_k, cos, sin, pos, **kw)
    torch.cuda.synchronize()
    assert la.latent_decode_attention.launches == n0 + 1
    assert out.dtype == torch.float32 and out.shape == (B, H, Rv)
    tol = TOL[dtype]
    torch.testing.assert_close(
        out, la.latent_attention_reference(q, tk, tv, a_k, cos, sin, pos, **kw),
        atol=tol, rtol=tol)


def _latent_case_inputs(rng, cuda, dt, B, H, KV, hd, T, Rk, Rv):
    q = torch.from_numpy(_randn(rng, B, H, hd)).to(cuda, dt)
    tk = torch.from_numpy(_randn(rng, B, T, Rk, scale=0.3)).to(cuda, dt)
    tv = torch.from_numpy(_randn(rng, B, T, Rv, scale=0.3)).to(cuda, dt)
    a_k = torch.from_numpy(_randn(rng, KV * hd, Rk, scale=Rk ** -0.5)).to(cuda, dt)
    inv = 1.0 / (10000.0 ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    fr = np.arange(T, dtype=np.float32)[:, None] * inv[None, :]
    emb = np.concatenate([fr, fr], axis=-1)
    return (q, tk, tv, a_k, torch.from_numpy(np.cos(emb)).to(cuda),
            torch.from_numpy(np.sin(emb)).to(cuda))


# The split form's edges (bf16): chunks of 128 keys, 1, 2 and 5 of them
# with a ragged last one, pos before the end of the cache, sliding windows
# that leave whole chunks out, rep 1/4/16, head dims 64/128 (256 takes the
# one-block-per-row form), and the smoke's MHA shape at T=2048.
SPLIT_EDGE_CASES = {
    # name: (B, H, KV, hd, T, Rk, Rv, pos, softcap, sliding)
    "b1_one_key": (1, 8, 8, 128, 1, 64, 64, 0, 0.0, 0),
    "b1_two_chunks_ragged": (1, 8, 8, 128, 200, 136, 72, 199, 0.0, 0),
    "five_chunks_ragged": (2, 8, 2, 128, 600, 256, 192, 599, 0.0, 0),
    "pos_before_end": (2, 4, 4, 128, 600, 128, 64, 301, 0.0, 0),
    "sliding_skips_chunks": (2, 8, 8, 128, 640, 64, 64, 600, 0.0, 100),
    "sliding_softcap_hd64": (1, 8, 2, 64, 512, 72, 40, 511, 30.0, 129),
    "rep4_hd64": (2, 16, 4, 64, 300, 96, 72, 250, 0.0, 0),
    "rep16_hd128": (1, 16, 1, 128, 260, 64, 56, 259, 0.0, 0),
    "hd256_tile32": (1, 4, 2, 256, 200, 64, 64, 199, 0.0, 0),
    "mha_smoke_t2048": (1, 32, 32, 128, 2048, 1024, 1024, 2047, 0.0, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SPLIT_EDGE_CASES))
def test_latent_attention_split_form_edges(cuda, case):
    B, H, KV, hd, T, Rk, Rv, pos, cap, sw = SPLIT_EDGE_CASES[case]
    rng = np.random.RandomState(len(case) + T)
    args = _latent_case_inputs(rng, cuda, torch.bfloat16, B, H, KV, hd, T, Rk, Rv)
    kw = dict(scale=hd ** -0.5, softcap=cap, sliding=sw, kv_heads=KV)
    want = "split_wgmma" if hd in (64, 128) else "tile32"
    assert la._form(torch.bfloat16, hd, Rk, Rv) == want
    n0 = la.latent_decode_attention.launches
    out = la._latent_attention_core(*args, pos, **kw)
    torch.cuda.synchronize()
    assert la.latent_decode_attention.launches == n0 + 1
    assert la.latent_decode_attention.last_form == want
    assert out.dtype == torch.float32 and out.shape == (B, H, Rv)
    tol = TOL["bfloat16"]
    torch.testing.assert_close(out, la.latent_attention_reference(*args, pos, **kw),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,pos", [(4, 544, 543), (1, 300, 200)])
def test_latent_attention_padded_ranks_take_split_form(cuda, B, T, pos):
    """The KV-target run's ranks (819, 409): as they are the tile32 form,
    zero-padded to multiples of 8 the split form, the same s (0 in the
    added columns)."""
    H = KV = 32
    hd, Rk, Rv = 128, 819, 409
    rng = np.random.RandomState(T)
    q, tk, tv, a_k, cos, sin = _latent_case_inputs(rng, cuda, torch.bfloat16,
                                                   B, H, KV, hd, T, Rk, Rv)
    kw = dict(scale=hd ** -0.5, softcap=0.0, sliding=0, kv_heads=KV)
    ref = la.latent_attention_reference(q, tk, tv, a_k, cos, sin, pos, **kw)
    pk, pv, pa = (torch.nn.functional.pad(t, (0, -t.shape[-1] % 8)) for t in (tk, tv, a_k))
    tol = TOL["bfloat16"]
    for args, form in (((tk, tv, a_k), "tile32"), ((pk, pv, pa), "split_wgmma")):
        n0 = la.latent_decode_attention.launches
        out = la._latent_attention_core(q, *args, cos, sin, pos, **kw)
        torch.cuda.synchronize()
        assert la.latent_decode_attention.launches == n0 + 1
        assert la.latent_decode_attention.last_form == form
        assert not out[..., Rv:].any()
        torch.testing.assert_close(out[..., :Rv], ref, atol=tol, rtol=tol)


def _tiny_lowrank_llama(device, head_dim=32, dtype=torch.float32):
    """A 2-layer Llama with low-rank q/k/v/down leaves on `device` (4 heads
    of `head_dim`, factorized in f32, then cast to `dtype`)."""
    from asvd4llm_tpu_torch.models.convert import params_from_numpy, params_to_numpy
    from asvd4llm_tpu_torch.models.init import init_params
    from asvd4llm_tpu_torch.models.registry import get_linear, lowrank_leaf, set_linear
    from asvd4llm_tpu_torch.models.spec import llama_spec
    from asvd4llm_tpu_torch.ops.asvd import factorize_linear

    spec = llama_spec(vocab_size=128, hidden_size=4 * head_dim,
                      intermediate_size=8 * head_dim, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=head_dim, max_position_embeddings=64)
    params = init_params(spec, torch.Generator().manual_seed(0), dtype=torch.float32)
    for i in range(2):
        for key in ("q_proj", "k_proj", "v_proj", "down_proj"):
            name = f"model.layers.{i}.{'mlp' if key == 'down_proj' else 'self_attn'}.{key}"
            leaf = get_linear(params, spec, name)
            f = factorize_linear(leaf["w"], leaf["b"], 0.6, backend="exact")
            params = set_linear(params, spec, name, lowrank_leaf(f.A, f.B, f.bias))
    return params_from_numpy(params_to_numpy(params), device=device, dtype=dtype), spec


def decode_step_kernels_vs_plain(device):
    """(fused logits, plain logits, launches of each kernel) per cache mode
    for one decode step of the tiny model after a 9-token prefill."""
    from asvd4llm_tpu_torch.eval.generate import decode_step, init_caches, prefill_host

    params, spec = _tiny_lowrank_llama(device)
    ids = torch.randint(0, 128, (2, 9), generator=torch.Generator().manual_seed(1))
    ids = ids.to(device)
    out = {}
    for latent in (False, "kv"):
        caches = init_caches(params, spec, 2, 12, torch.float32, latent=latent)
        _, caches = prefill_host(params, spec, ids, caches, latent=latent)
        tok = ids[:, -1:]
        c1 = [{k: v.clone() for k, v in c.items()} for c in caches]
        n1, n2 = fl.fused_lowrank_apply.launches, la.latent_decode_attention.launches
        fused, _ = decode_step(params, spec, tok, c1, 9, use_pallas=True)
        launched = (fl.fused_lowrank_apply.launches - n1,
                    la.latent_decode_attention.launches - n2)
        plain, _ = decode_step(params, spec, tok, caches, 9, use_pallas=False)
        out[latent] = (fused, plain, launched)
    return out


@pytest.mark.gpu
def test_decode_step_with_kernels_on_card(cuda):
    """A decode step with the kernels agrees with the plain tensor path in
    f32, and launched kernel 1 on every low-rank leaf and kernel 2 on each
    latent layer."""
    for latent, (fused, plain, (n_fused, n_latent)) in \
            decode_step_kernels_vs_plain(cuda).items():
        assert n_fused == 8 - (4 if latent == "kv" else 0)
        assert n_latent == (2 if latent == "kv" else 0)
        torch.testing.assert_close(fused, plain, atol=1e-4, rtol=1e-4)


# ------------------------------------------------- kernels 3 and 4 (q8, q4)

def _q8_inputs(rng, cuda, dt, M, K, N, R, bias, pad):
    """x and int8 factors quantized by the port; `pad` widens the code
    arrays (true N/R/K stay in the scales) as pre-padded leaves arrive."""
    from asvd4llm_tpu_torch.ops.quant import quantize_to_int
    x = torch.from_numpy(_randn(rng, M, K)).to(cuda, dt)
    a8, aq = quantize_to_int(torch.from_numpy(_randn(rng, N, R, scale=R ** -0.5)).to(cuda), 8)
    b8, bq = quantize_to_int(torch.from_numpy(_randn(rng, R, K, scale=K ** -0.5)).to(cuda), 8)
    if pad:
        a8 = torch.nn.functional.pad(a8, (0, 128 - R % 128, 0, 512 - N % 512))
        b8 = torch.nn.functional.pad(b8, (0, 512 - K % 512, 0, 128 - R % 128))
    bv = torch.from_numpy(_randn(rng, N, scale=0.1)).to(cuda, dt) if bias else None
    return x, a8, aq, b8, bq, bv


Q_SHAPES = [  # (M, K, N, R, bias)
    (1, 4096, 4096, 1920, True),      # Llama-2-7B q_proj at ratio 0.9
    (4, 11008, 4096, 2688, False),    # down_proj, decode batch 4
    (16, 512, 1024, 512, True),       # the largest decode-path M
    (17, 1024, 520, 512, False),      # the smallest tiled-path M
    (200, 512, 300, 1024, True),
    (1024, 1024, 512, 512, True),     # the largest fused M
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,R,bias", Q_SHAPES + [
    (3, 300, 200, 50, True),          # K and R not multiples of 16: CUDA-core forms
    (40, 264, 100, 24, False),
])
@pytest.mark.parametrize("pad", [False, True])
def test_fused_q8_kernel_matches_plain(cuda, dtype, M, K, N, R, bias, pad):
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    rng = np.random.RandomState(M + K + R)
    dt = getattr(torch, dtype)
    x, a8, aq, b8, bq, bv = _q8_inputs(rng, cuda, dt, M, K, N, R, bias, pad)
    n0 = fq.fused_lowrank_apply_q8.launches
    out = fq.fused_lowrank_apply_q8(x, a8, aq, b8, bq, bv)
    torch.cuda.synchronize()
    assert fq.fused_lowrank_apply_q8.launches == n0 + 1
    assert out.dtype == dt and out.shape == (M, N)
    ref = fq.fused_lowrank_q8_reference(x, a8, aq.scale, aq.zero, b8, bq.scale, bq.zero, bv)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def _q4_inputs(rng, cuda, dt, M, K, N, R, bias, group, pad):
    """x and packed 4-bit factors quantized by the port (R padded to Rp as
    quantize_lowrank_factors_int4 does); `pad` adds rows to A4 up to a
    multiple of 512 as pre-padded leaves arrive."""
    from asvd4llm_tpu_torch.ops.quant import quantize_to_int4_grouped
    x = torch.from_numpy(_randn(rng, M, K)).to(cuda, dt)
    a4, asc, azs = quantize_to_int4_grouped(
        torch.from_numpy(_randn(rng, N, R, scale=R ** -0.5)).to(cuda), group=group)
    b4, bsc, bzs = quantize_to_int4_grouped(
        torch.from_numpy(_randn(rng, R, K, scale=K ** -0.5)).to(cuda), group=group)
    rp = a4.shape[1] * 2 - R
    b4, bsc, bzs = (torch.nn.functional.pad(v, (0, 0, 0, rp)) for v in (b4, bsc, bzs))
    if pad:
        a4 = torch.nn.functional.pad(a4, (0, 0, 0, -N % 512))
    bv = torch.from_numpy(_randn(rng, N, scale=0.1)).to(cuda, dt) if bias else None
    return x, (a4, asc, azs, b4, bsc, bzs), bv


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,R,bias", Q_SHAPES + [
    (3, 300, 200, 50, True),          # K and R far from the 512 padding
    (40, 640, 100, 140, False),
])
@pytest.mark.parametrize("group,pad", [(128, False), (64, True), (16, False), (256, True)])
def test_fused_q4_kernel_matches_plain(cuda, dtype, M, K, N, R, bias, group, pad):
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    rng = np.random.RandomState(M + K + R + group)
    dt = getattr(torch, dtype)
    x, q, bv = _q4_inputs(rng, cuda, dt, M, K, N, R, bias, group, pad)
    n0 = fq.fused_lowrank_apply_q4.launches
    out = fq.fused_lowrank_apply_q4(x, *q, bv, group=group)
    torch.cuda.synchronize()
    assert fq.fused_lowrank_apply_q4.launches == n0 + 1
    assert out.dtype == dt and out.shape == (M, N)
    ref = fq.fused_lowrank_q4_reference(x, *q, bv, group=group)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_quantized_kernels_raise_instead_of_falling_back(cuda, monkeypatch):
    """Bad inputs raise; a failed build raises out of the wrapper; above
    MAX_FUSED_TOKENS the op is dequantize + two matmuls (no launch)."""
    from asvd4llm_tpu_torch.ops import _build
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    rng = np.random.RandomState(0)
    x, a8, aq, b8, bq, _ = _q8_inputs(rng, cuda, torch.float32, 40, 64, 48, 8, False, False)
    xq4, q, _ = _q4_inputs(rng, cuda, torch.float32, 40, 64, 48, 8, False, 128, False)
    n8, n4 = fq.fused_lowrank_apply_q8.launches, fq.fused_lowrank_apply_q4.launches
    fq.fused_lowrank_apply_q8(x, a8, aq, b8, bq, max_tokens=16)
    fq.fused_lowrank_apply_q4(xq4, *q, max_tokens=16)
    assert (fq.fused_lowrank_apply_q8.launches, fq.fused_lowrank_apply_q4.launches) == (n8, n4)
    with pytest.raises(TypeError):
        fq.fused_lowrank_apply_q8(x, a8.float(), aq, b8, bq)
    with pytest.raises(TypeError):  # scales rounded to bf16 are refused
        fq.fused_lowrank_apply_q4(xq4, q[0], q[1].bfloat16(), *q[2:])
    with pytest.raises(ValueError):
        fq.fused_lowrank_apply_q4(xq4, *q, group=96)
    # a launch the library refuses (a rank that is not a multiple of 512)
    # comes back as an error, not as a silent fallback
    with pytest.raises(RuntimeError, match="launch failed"):
        fq._launch("fused_lowrank_q4", xq4, (xq4, *q[3:], *q[:3], None),
                   (40, 64, 100, 512, 48, 128, 0), 48, 100)

    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")
    monkeypatch.setattr(_build, "library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fq.fused_lowrank_apply_q8(x, a8, aq, b8, bq)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fq.fused_lowrank_apply_q4(xq4, *q)


@pytest.mark.gpu
@pytest.mark.parametrize("deploy", ["int8", "int4"])
def test_decode_step_with_quantized_kernels_on_card(cuda, deploy):
    """A decode step over q8 / q4 leaves with the kernels agrees with the
    dequantize + matmul path in f32 and launches the kernel on every
    quantized leaf."""
    from asvd4llm_tpu_torch.eval.generate import decode_step, init_caches, prefill_host
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    from asvd4llm_tpu_torch.ops import quant_apply

    params, spec = _tiny_lowrank_llama(cuda)
    if deploy == "int8":
        params, counter = quant_apply.quantize_lowrank_factors_int8(params, spec), \
            fq.fused_lowrank_apply_q8
    else:
        params, counter = quant_apply.quantize_lowrank_factors_int4(params, spec), \
            fq.fused_lowrank_apply_q4
    ids = torch.randint(0, 128, (2, 9), generator=torch.Generator().manual_seed(1)).to(cuda)
    caches = init_caches(params, spec, 2, 12, torch.float32, latent="kv")
    assert all("k" in c for c in caches)  # quantized k/v leaves keep dense caches
    _, caches = prefill_host(params, spec, ids, caches, latent="kv")
    c1 = [{k: v.clone() for k, v in c.items()} for c in caches]
    n0 = counter.launches
    fused, _ = decode_step(params, spec, ids[:, -1:], c1, 9, use_pallas=True)
    assert counter.launches - n0 == 8
    plain, _ = decode_step(params, spec, ids[:, -1:], caches, 9, use_pallas=False)
    torch.testing.assert_close(fused, plain, atol=1e-4, rtol=1e-4)


# ------------------------------------------------- kernels 5 and 6 (paged) --

PAGED_CASES = {
    # name: (kernel, B, KV, rep, hd, page, Rk, Rv, softcap, sliding)
    "dense_p8_mha": ("dense", 4, 8, 1, 128, 8, 0, 0, 0.0, 0),
    "dense_p256_gqa4": ("dense", 3, 4, 4, 128, 256, 0, 0, 0.0, 0),
    "dense_p16_gqa8_hd64_sliding": ("dense", 8, 2, 8, 64, 16, 0, 0, 0.0, 40),
    "vlatent_p16_rep4_rv3072": ("vlatent", 2, 2, 4, 128, 16, 0, 3072, 0.0, 0),
    "vlatent_p256_mha_hd64_softcap": ("vlatent", 4, 8, 1, 64, 256, 0, 1024, 30.0, 0),
    "latent_p8_mha": ("latent", 4, 8, 1, 128, 8, 256, 192, 0.0, 0),
    "latent_p256_gqa8_hd64_sliding": ("latent", 2, 2, 8, 64, 256, 512, 3072, 0.0, 100),
    "latent_p16_rep4_odd_rank": ("latent", 3, 4, 4, 128, 16, 100, 72, 20.0, 0),
}


def _paged_case_inputs(rng, cuda, dt, B, KV, rep, hd, page, Rk, Rv):
    """Shuffled pages; ragged positions from 0 to the last slot, with a
    partial last page; row 1 an idle slot (page table all 0, position 0).
    Rows hold up to 320 keys (768 at page 256), so the kernels' 128-key
    chunks straddle small pages."""
    mp = max(3, 320 // page)
    n_pages = 1 + B * mp
    pt = (rng.permutation(n_pages - 1) + 1).reshape(B, mp).astype(np.int32)
    pt[1] = 0
    positions = rng.randint(0, mp * page, B).astype(np.int32)
    positions[0], positions[1] = mp * page - 1, 0
    if B > 2:
        positions[2] = page + 3
    H = KV * rep

    def t(*shape, scale=0.5, dtype=dt):
        return torch.from_numpy(_randn(rng, *shape, scale=scale)).to(cuda, dtype)
    inv = 1.0 / (10000.0 ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    fr = np.arange(mp * page, dtype=np.float32)[:, None] * inv[None, :]
    emb = np.concatenate([fr, fr], axis=-1)
    return dict(
        q=t(B, H, hd, scale=1.0, dtype=torch.float32),
        k_pool=t(n_pages, page, KV, hd), v_pool=t(n_pages, page, KV, hd),
        tv_pool=t(n_pages, page, max(Rv, 1)), tk_pool=t(n_pages, page, max(Rk, 1)),
        a_k=t(KV * hd, max(Rk, 1), scale=max(Rk, 1) ** -0.5),
        cos=torch.from_numpy(np.cos(emb)).to(cuda), sin=torch.from_numpy(np.sin(emb)).to(cuda),
        pt=torch.from_numpy(pt).to(cuda), positions=torch.from_numpy(positions).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_kernels_match_plain(cuda, dtype, case):
    from asvd4llm_tpu_torch.ops import paged_attention as pa
    kind, B, KV, rep, hd, page, Rk, Rv, cap, sw = PAGED_CASES[case]
    rng = np.random.RandomState(len(case) + page)
    d = _paged_case_inputs(rng, cuda, getattr(torch, dtype), B, KV, rep, hd, page, Rk, Rv)
    kw = dict(scale=hd ** -0.5, softcap=cap, sliding=sw, kv_heads=KV)
    if kind == "latent":
        args = (d["q"], d["tk_pool"], d["tv_pool"], d["a_k"], d["cos"], d["sin"],
                d["pt"], d["positions"])
        counter, core, ref_fn = (pa.paged_latent_decode_attention, pa._paged_latent_core,
                                 pa.paged_latent_reference)
    else:
        args = (d["q"], d["k_pool"], d["v_pool"] if kind == "dense" else d["tv_pool"],
                d["pt"], d["positions"])
        counter, core, ref_fn = (pa.paged_dense_decode_attention, pa._paged_dense_core,
                                 pa.paged_dense_reference)
    n0 = counter.launches
    out = core(*args, **kw)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    tol = TOL[dtype]
    torch.testing.assert_close(out, ref_fn(*args, **kw), atol=tol, rtol=tol)


# Kernel 6's split form at its edges (bf16): page sizes 8 to 512 (boxes of
# 8..128 rows, or 128-row boxes inside a page), positions on chunk and page
# boundaries, an idle slot, GQA rep 4, head dim 64, the "kv" serve run's
# padded ranks 824/416 and 1024, sliding windows and softcap. Each case runs
# both forms on the same inputs: split_wgmma as `_latent_form` picks it,
# tile32 when named.
PAGED_SPLIT_EDGE_CASES = {
    # name: (P, KV, rep, hd, Rk, Rv, softcap, sliding)
    "p8_mha_r824_416": (8, 8, 1, 128, 824, 416, 0.0, 0),
    "p16_rep4_hd64_sliding": (16, 2, 4, 64, 256, 192, 0.0, 100),
    "p64_softcap_r1024": (64, 4, 1, 128, 1024, 1024, 30.0, 0),
    "p128_rep4": (128, 2, 4, 128, 512, 256, 0.0, 0),
    "p256_mha_r1024": (256, 8, 1, 128, 1024, 1024, 0.0, 0),
    "p512_hd64_sliding_softcap": (512, 2, 2, 64, 136, 72, 20.0, 300),
}


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["split_wgmma", "tile32"])
@pytest.mark.parametrize("case", sorted(PAGED_SPLIT_EDGE_CASES))
def test_paged_latent_split_form_edges(cuda, case, form):
    from asvd4llm_tpu_torch.ops import paged_attention as pa
    P, KV, rep, hd, Rk, Rv, cap, sw = PAGED_SPLIT_EDGE_CASES[case]
    rng = np.random.RandomState(P + Rk)
    d = _paged_case_inputs(rng, cuda, torch.bfloat16, 7, KV, rep, hd, P, Rk, Rv)
    mp = d["pt"].shape[1]
    # rows at the last key, idle (page table all 0), the end and start of a
    # chunk, of a page, inside the second page
    positions = [mp * P - 1, 0, 127, 128, P - 1, P, P + 3]
    B = len(positions)
    d["positions"] = torch.tensor(positions, dtype=torch.int32, device=cuda)
    args = (d["q"], d["tk_pool"], d["tv_pool"], d["a_k"], d["cos"], d["sin"], d["pt"],
            d["positions"])
    kw = dict(scale=hd ** -0.5, softcap=cap, sliding=sw, kv_heads=KV)
    assert pa._latent_form(torch.bfloat16, hd, Rk, Rv, P) == "split_wgmma"
    counter = pa.paged_latent_decode_attention
    n0 = counter.launches
    out = pa._paged_latent_core(*args, form=None if form == "split_wgmma" else form, **kw)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1 and counter.last_form == form
    assert out.shape == (B, KV * rep, Rv) and bool(torch.isfinite(out).all())
    tol = TOL["bfloat16"]
    torch.testing.assert_close(out, pa.paged_latent_reference(*args, **kw), atol=tol, rtol=tol)


# Kernel 3's tiled form at its edges (bf16): the smallest tiled M, one and
# two row tiles, the PPL eval's M = 1024 at the seven Llama-2-7B linears,
# ranks that are not multiples of 64 (but of 16, so that unpadded A8 rows
# stay 16-byte aligned), codes padded past their true dims, bias on and
# off; each also in the WMMA form on the same inputs.
Q8_WGMMA_SHAPES = [  # (M, K, N, R)
    (17, 256, 130, 48), (64, 512, 136, 208), (129, 1024, 520, 80),
    (1024, 4096, 4096, 1920), (1024, 4096, 11008, 2688), (1024, 11008, 4096, 2688),
]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,R", Q8_WGMMA_SHAPES)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("pad", [False, True])
def test_fused_q8_wgmma_form_edges(cuda, M, K, N, R, bias, pad):
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    rng = np.random.RandomState(M + N + R)
    x, a8, aq, b8, bq, bv = _q8_inputs(rng, cuda, torch.bfloat16, M, K, N, R, bias, pad)
    args = (x, a8, aq.scale, aq.zero, b8, bq.scale, bq.zero, bv)
    ref = fq.fused_lowrank_q8_reference(*args).float()
    assert fq._form_q8(M, K, R, b8.shape[1], a8.shape[1], torch.bfloat16) == "wgmma_tiled"
    counter = fq.fused_lowrank_apply_q8
    tol = TOL["bfloat16"]
    for form in (None, "wmma_tiled"):
        n0 = counter.launches
        out = fq._launch_q8(*args, form=form)
        torch.cuda.synchronize()
        assert counter.launches == n0 + 1 and counter.last_form == (form or "wgmma_tiled")
        assert out.dtype == torch.bfloat16 and out.shape == (M, N)
        torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)


# Kernel 4's tiled form at its edges (bf16): the smallest tiled M, one and
# two row tiles, the PPL eval's M = 1024 at Llama-2-7B linears, K short of
# its 512 padding, groups 64 and 128, bias on and off; each also in the
# WMMA form on the same inputs.
Q4_WGMMA_SHAPES = [  # (M, K, N, R)
    (17, 512, 130, 100), (64, 1000, 136, 600), (129, 1024, 520, 512),
    (1024, 4096, 4096, 1920), (1024, 4096, 11008, 2688), (1024, 11008, 4096, 2688),
]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,R", Q4_WGMMA_SHAPES)
@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("bias", [True, False])
def test_fused_q4_wgmma_form_edges(cuda, M, K, N, R, group, bias):
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    rng = np.random.RandomState(M + N + R + group)
    x, q, bv = _q4_inputs(rng, cuda, torch.bfloat16, M, K, N, R, bias, group, False)
    ref = fq.fused_lowrank_q4_reference(x, *q, bv, group=group).float()
    assert fq._form_q4(M, K, torch.bfloat16) == "wgmma_tiled"
    counter = fq.fused_lowrank_apply_q4
    tol = TOL["bfloat16"]
    for form in (None, "wmma_tiled"):
        n0 = counter.launches
        out = fq._launch_q4(x, *q, bv, group, form=form)
        torch.cuda.synchronize()
        assert counter.launches == n0 + 1 and counter.last_form == (form or "wgmma_tiled")
        assert out.dtype == torch.bfloat16 and out.shape == (M, N)
        torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)


# Kernel 5's split form at its edges (bf16): page sizes 8 to 512 (boxes of
# 8..32 rows, or 64-row boxes inside a page), positions on chunk and page
# boundaries, an idle slot, shuffled pages, MHA and GQA (V-latent head blocks
# of several groups, and of one group wider than 8 heads), head dim 64,
# sliding windows and softcap, both variants. Each case runs both forms on
# the same inputs: split_tma as `_dense_form` picks it, tile32 when named.
PAGED_DENSE_SPLIT_CASES = {
    # name: (P, KV, rep, hd, Rv (0: dense V), softcap, sliding)
    "p8_mha_dense": (8, 8, 1, 128, 0, 0.0, 0),
    "p8_mha_vlatent_r416": (8, 16, 1, 128, 416, 0.0, 0),
    "p16_gqa4_hd64_dense_sliding": (16, 2, 4, 64, 0, 0.0, 100),
    "p32_gqa4_vlatent_softcap": (32, 4, 4, 128, 1024, 30.0, 0),
    "p64_gqa16_dense": (64, 2, 16, 128, 0, 0.0, 0),
    "p64_rep16_vlatent_hd64": (64, 2, 16, 64, 200, 0.0, 0),
    "p256_mha_dense_softcap": (256, 8, 1, 128, 0, 20.0, 0),
    "p256_mha_vlatent_sliding": (256, 8, 1, 128, 1024, 0.0, 300),
    "p512_gqa2_vlatent_hd64": (512, 4, 2, 64, 72, 0.0, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["split_tma", "tile32"])
@pytest.mark.parametrize("case", sorted(PAGED_DENSE_SPLIT_CASES))
def test_paged_dense_split_form_edges(cuda, case, form):
    from asvd4llm_tpu_torch.ops import paged_attention as pa
    P, KV, rep, hd, Rv, cap, sw = PAGED_DENSE_SPLIT_CASES[case]
    rng = np.random.RandomState(P + Rv + rep)
    d = _paged_case_inputs(rng, cuda, torch.bfloat16, 7, KV, rep, hd, P, 0, Rv)
    mp = d["pt"].shape[1]
    # rows at the last key, idle (page table all 0, position 0), the end and
    # start of a 64-key chunk, of a page, inside the second page
    positions = [mp * P - 1, 0, 63, 64, P - 1, P, P + 3]
    d["positions"] = torch.tensor(positions, dtype=torch.int32, device=cuda)
    v = d["tv_pool"] if Rv else d["v_pool"]
    args = (d["q"], d["k_pool"], v, d["pt"], d["positions"])
    kw = dict(scale=hd ** -0.5, softcap=cap, sliding=sw, kv_heads=KV)
    assert pa._dense_form(torch.bfloat16, hd, Rv or hd, P) == "split_tma"
    counter = pa.paged_dense_decode_attention
    n0 = counter.launches
    out = pa._paged_dense_core(*args, form=None if form == "split_tma" else form, **kw)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1 and counter.last_form == form
    assert out.shape == (7, KV * rep, Rv or hd) and bool(torch.isfinite(out).all())
    tol = TOL["bfloat16"]
    torch.testing.assert_close(out, pa.paged_dense_reference(*args, **kw), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_new_forms_refuse_shapes_they_do_not_take(cuda):
    """A form named for a shape it does not take raises from the launcher:
    nothing falls back to another form or to the plain version."""
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    from asvd4llm_tpu_torch.ops import paged_attention as pa
    rng = np.random.RandomState(1)
    d = _paged_case_inputs(rng, cuda, torch.bfloat16, 2, 2, 2, 64, 16, 100, 72)
    args = (d["q"], d["tk_pool"], d["tv_pool"], d["a_k"], d["cos"], d["sin"], d["pt"],
            d["positions"])
    kw = dict(scale=0.125, softcap=0.0, sliding=0, kv_heads=2)
    with pytest.raises(RuntimeError, match="launch failed"):   # Rk = 100
        pa._paged_latent_core(*args, form="split_wgmma", **kw)
    x, a8, aq, b8, bq, bv = _q8_inputs(rng, cuda, torch.float32, 40, 256, 48, 64, True, False)
    with pytest.raises(RuntimeError, match="launch failed"):   # f32
        fq._launch_q8(x, a8, aq.scale, aq.zero, b8, bq.scale, bq.zero, bv, form="wgmma_tiled")
    for dt, M in ((torch.float32, 40), (torch.bfloat16, 4)):   # f32; a decode M
        x4, q, bv4 = _q4_inputs(rng, cuda, dt, M, 512, 48, 100, True, 128, False)
        with pytest.raises(RuntimeError, match="launch failed"):
            fq._launch_q4(x4, *q, bv4, 128, form="wgmma_tiled")
    for dt, P in ((torch.float32, 16), (torch.bfloat16, 24)):  # f32; a page of 24 rows
        d = _paged_case_inputs(rng, cuda, dt, 2, 2, 2, 64, P, 0, 64)
        with pytest.raises(RuntimeError, match="launch failed"):
            pa._paged_dense_core(d["q"], d["k_pool"], d["tv_pool"], d["pt"], d["positions"],
                                 form="split_tma", **kw)


@pytest.mark.gpu
def test_paged_kernels_raise_instead_of_falling_back(cuda):
    from asvd4llm_tpu_torch.ops import paged_attention as pa
    rng = np.random.RandomState(0)
    d = _paged_case_inputs(rng, cuda, torch.float32, 2, 2, 2, 64, 16, 32, 24)
    kw = dict(scale=0.125, softcap=0.0, sliding=0, kv_heads=2)
    with pytest.raises(TypeError):          # the core takes q in f32 only
        pa._paged_dense_core(d["q"].bfloat16(), d["k_pool"], d["v_pool"], d["pt"],
                             d["positions"], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        pa._paged_dense_core(d["q"], d["k_pool"].transpose(2, 3).contiguous().transpose(2, 3),
                             d["v_pool"], d["pt"], d["positions"], **kw)
    with pytest.raises(TypeError):          # an f32 A_k over bf16 pools
        pa.paged_latent_decode_attention(
            d["q"], d["tk_pool"].bfloat16(), d["tv_pool"].bfloat16(), d["a_k"], d["a_k"],
            d["cos"], d["sin"], d["pt"], d["positions"], kv_heads=2, scale=0.125)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [False, "v", "kv"])
def test_paged_engine_kernels_match_gather_path_on_card(cuda, mode):
    """The serving engine on the card, f32: use_pallas=True (kernels 1, 5
    and 6) emits the tokens of use_pallas=False (the gather path), and the
    mode's paged kernel launched."""
    from asvd4llm_tpu_torch.ops import paged_attention as pa
    from asvd4llm_tpu_torch.serving import PagedEngine
    params, spec = _tiny_lowrank_llama(cuda)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 128, (n,)) for n in (7, 19, 12)]
    counter = pa.paged_latent_decode_attention if mode == "kv" \
        else pa.paged_dense_decode_attention
    outs = []
    for up in (True, False):
        eng = PagedEngine(params, spec, max_batch=2, page_size=8, num_pages=32,
                          max_pages_per_seq=6, latent=mode, use_pallas=up)
        n0 = counter.launches
        rids = [eng.add_request(p, max_new_tokens=n) for p, n in zip(prompts, (9, 5, 7))]
        eng.run()
        assert (counter.launches > n0) == up
        outs.append([eng.result(r).tolist() for r in rids])
    assert outs[0] == outs[1]


# ------------------------------------------ on-device decode (CUDA graphs)

@pytest.mark.gpu
@pytest.mark.parametrize("sliding", [0, 100])
def test_latent_attention_position_on_card_at_every_step(cuda, sliding):
    """Kernel 2's split form with its position as one int32 on the card, at
    every position of one decode over T=300 (three 128-key chunks, the last
    ragged; the same tensor advanced in place), against the plain version;
    then one launch captured into a CUDA graph at position 0 and replayed
    after the position passed each chunk boundary."""
    B, H, KV, hd, T, Rk, Rv = 2, 8, 2, 64, 300, 64, 48
    rng = np.random.RandomState(sliding + 1)
    bf = lambda *shape, scale=1.0: torch.from_numpy(  # noqa: E731
        _randn(rng, *shape, scale=scale)).to(cuda, torch.bfloat16)
    q, tk, tv = bf(B, H, hd), bf(B, T, Rk, scale=0.5), bf(B, T, Rv, scale=0.5)
    a_k = bf(KV * hd, Rk, scale=Rk ** -0.5)
    ang = torch.from_numpy(_randn(rng, T, hd)).to(cuda)
    cos, sin = ang.cos().contiguous(), ang.sin().contiguous()
    kw = dict(scale=hd ** -0.5, softcap=0.0, sliding=sliding, kv_heads=KV)
    p = torch.zeros((), dtype=torch.int32, device=cuda)
    tol = TOL["bfloat16"]
    for pos in range(T):
        p.fill_(pos)
        out = la._latent_attention_core(q, tk, tv, a_k, cos, sin, p, **kw)
        assert la.latent_decode_attention.last_form == "split_wgmma"
        ref = la.latent_attention_reference(q, tk, tv, a_k, cos, sin, pos, **kw)
        torch.testing.assert_close(out, ref, atol=tol, rtol=tol, msg=f"position {pos}")
    p.zero_()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        la._latent_attention_core(q, tk, tv, a_k, cos, sin, p, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = la._latent_attention_core(q, tk, tv, a_k, cos, sin, p, **kw)
    for pos in (0, 127, 128, 200, 255, 256, 299):
        p.fill_(pos)
        graph.replay()
        ref = la.latent_attention_reference(q, tk, tv, a_k, cos, sin, pos, **kw)
        torch.testing.assert_close(out, ref, atol=tol, rtol=tol, msg=f"replay at {pos}")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [False, "kv", "v"])
def test_generate_on_device_matches_generate_on_card(cuda, mode):
    """generate_on_device (a captured decode step replayed per token) emits
    generate's tokens (eager steps), f32, with the kernels; the launch
    counters count each replay: the graph path launches what the eager path
    does plus its one warm-up step."""
    from asvd4llm_tpu_torch.eval.generate import generate, generate_on_device
    params, spec = _tiny_lowrank_llama(cuda)
    prompt = np.random.RandomState(2).randint(0, 128, (2, 9))
    kw = dict(max_new_tokens=8, latent_kv=mode, use_pallas=True)
    n0 = (fl.fused_lowrank_apply.launches, la.latent_decode_attention.launches)
    eager = generate(params, spec, prompt, **kw)
    n1 = (fl.fused_lowrank_apply.launches, la.latent_decode_attention.launches)
    graph = generate_on_device(params, spec, prompt, **kw)
    n2 = (fl.fused_lowrank_apply.launches, la.latent_decode_attention.launches)
    np.testing.assert_array_equal(graph, eager)
    # kernel 1 on q, k, v, down of each layer but the k/v that go to latents;
    # kernel 2 on each latent layer
    per_step = ({False: 8, "v": 6, "kv": 4}[mode], 2 if mode == "kv" else 0)
    for k in range(2):
        assert n1[k] - n0[k] == 7 * per_step[k]          # 7 eager decode steps
        assert n2[k] - n1[k] == 8 * per_step[k]          # warm-up + 7 replays


@pytest.mark.gpu
def test_generate_on_device_replays_past_a_chunk_boundary(cuda):
    """bf16, head_dim 64, latent {tk, tv} caches: kernel 2 takes its split
    form, and the decode runs from position 120 past the 128-key chunk
    boundary. The replayed graph emits the eager loop's tokens and stops
    early on EOS as the host loop does."""
    from asvd4llm_tpu_torch.eval.generate import generate, generate_on_device
    params, spec = _tiny_lowrank_llama(cuda, head_dim=64, dtype=torch.bfloat16)
    prompt = np.random.RandomState(4).randint(0, 128, (2, 120))
    kw = dict(max_new_tokens=16, latent_kv=True, use_pallas=True)
    forms0 = dict(la.latent_decode_attention.form_launches)
    eager = generate(params, spec, prompt, **kw)
    graph = generate_on_device(params, spec, prompt, **kw)
    np.testing.assert_array_equal(graph, eager)
    assert la.latent_decode_attention.form_launches.get("split_wgmma", 0) > \
        forms0.get("split_wgmma", 0)
    eos = int(eager[0, 120 + 10])
    np.testing.assert_array_equal(
        generate_on_device(params, spec, prompt, eos_token_id=eos, **kw),
        generate(params, spec, prompt, eos_token_id=eos, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [False, "v", "kv"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_paged_engine_graph_matches_eager_steps_on_card(cuda, mode, chunk):
    """The engine's captured decode step (one graph per n_steps) emits the
    tokens of its eager steps (eager_steps=True), greedy and sampled, with
    admission and retirement mid-run; the paged kernel's counter counts the
    replays."""
    from asvd4llm_tpu_torch.ops import paged_attention as pa
    from asvd4llm_tpu_torch.serving import PagedEngine
    params, spec = _tiny_lowrank_llama(cuda)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 128, (n,)) for n in (7, 19, 12)]
    counter = pa.paged_latent_decode_attention if mode == "kv" \
        else pa.paged_dense_decode_attention
    for sample in ({}, dict(temperature=0.8, top_p=0.9, seed=3)):
        outs, launched = [], []
        for eager in (True, False):
            eng = PagedEngine(params, spec, max_batch=2, page_size=8, num_pages=32,
                              max_pages_per_seq=6, latent=mode, use_pallas=True,
                              eager_steps=eager, **sample)
            n0 = counter.launches
            rids = [eng.add_request(p, max_new_tokens=n) for p, n in zip(prompts, (9, 5, 7))]
            eng.run(chunk=chunk)
            launched.append(counter.launches - n0)
            outs.append([eng.result(r).tolist() for r in rids])
        assert outs[0] == outs[1]
        # the graph path adds one warm-up step (one launch per layer) to the
        # replays of its one captured n_steps
        assert launched[1] - launched[0] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "f32", "q8", "q4"])
def test_split_k_forms_give_the_same_bits_every_run(cuda, kind):
    """The split-K forms of kernels 1, 3 and 4 sum their partials in
    fixed-point accumulators with integer atomics, so repeated calls give
    the same bits whatever order the blocks finish in (a decode replayed
    from a CUDA graph emits the eager loop's tokens)."""
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    from asvd4llm_tpu_torch.ops.quant import quantize_to_int
    rng = np.random.RandomState(11)
    M, K, N, R = 4, 4096, 4096, 1920
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    x = torch.from_numpy(_randn(rng, M, K)).to(cuda, dt)
    a = torch.from_numpy(_randn(rng, N, R, scale=R ** -0.5)).to(cuda)
    b = torch.from_numpy(_randn(rng, R, K, scale=K ** -0.5)).to(cuda)
    if kind in ("bf16", "f32"):
        def call():
            return fl.fused_lowrank_apply(x, a.to(dt), b.to(dt), None)
    elif kind == "q8":
        a8, aq = quantize_to_int(a, 8)
        b8, bq = quantize_to_int(b, 8)

        def call():
            return fq.fused_lowrank_apply_q8(x, a8, aq, b8, bq, None)
    else:
        x, q, _ = _q4_inputs(rng, cuda, dt, M, K, N, R, False, 128, False)

        def call():
            return fq.fused_lowrank_apply_q4(x, *q, None, group=128)
    first = call()
    for _ in range(5):
        assert torch.equal(call(), first)


# ------------------------------------------- Fisher calibration and export

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fisher_on_card_matches_cpu(cuda, dtype):
    """calib_fisher_info on the card against the same call on the CPU in
    f32: f32 within rtol 1e-3 (another summation order); bf16 weights
    within 5% of each vector's largest entry (the gradients themselves are
    bf16, 8 bits of mantissa, through two layers' backward). The card's
    weights come back without gradients."""
    from asvd4llm_tpu_torch.calib.fisher import calib_fisher_info
    from asvd4llm_tpu_torch.models.convert import params_from_numpy, params_to_numpy
    from asvd4llm_tpu_torch.models.init import init_params
    from asvd4llm_tpu_torch.models.spec import llama_spec

    spec = llama_spec(vocab_size=128, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
                      max_position_embeddings=64)
    host = init_params(spec, torch.Generator().manual_seed(0), dtype=torch.float32)
    card = params_from_numpy(params_to_numpy(host), device=cuda,
                             dtype=getattr(torch, dtype))
    rng = np.random.RandomState(3)
    loader = [{"input_ids": rng.randint(0, 128, (2, 33))} for _ in range(3)]
    ref = calib_fisher_info(host, spec, loader)
    got = calib_fisher_info(card, spec, loader)
    assert set(got) == set(ref)
    for k in ref:
        g = got[k].cpu()
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), k
        if dtype == "float32":
            torch.testing.assert_close(g, ref[k], rtol=1e-3, atol=1e-7)
        else:
            assert float((g - ref[k]).abs().max()) <= 0.05 * float(ref[k].abs().max()), k
    assert all(leaf["w"].grad is None and not leaf["w"].requires_grad
               for layer in card["layers"] for leaf in layer.values()
               if isinstance(leaf, dict) and "w" in leaf and leaf["w"].dim() == 2)


@pytest.mark.gpu
def test_export_round_trip_on_card(cuda, tmp_path):
    """A bf16 low-rank model on the card through the native checkpoint and
    the HF repo: both reload onto the card equal to the model (bit for bit;
    the f32 repo exactly after the cast back to bf16) and decode its greedy
    tokens through the kernels."""
    import dataclasses

    from asvd4llm_tpu_torch.eval.generate import generate_on_device
    from asvd4llm_tpu_torch.export.checkpoint import load_compressed, save_compressed
    from asvd4llm_tpu_torch.export.hf_repo import export_hf_repo
    from asvd4llm_tpu_torch.models.loader import load_model

    params, spec = _tiny_lowrank_llama(cuda, dtype=torch.bfloat16)
    ranks = {"model.layers.0.self_attn.q_proj": int(params["layers"][0]["q_proj"]["A"].shape[1])}
    save_compressed(str(tmp_path / "native"), params, spec, ranks)
    export_hf_repo(str(tmp_path / "repo"), params, spec, ranks)
    native, spec2, ranks2 = load_compressed(str(tmp_path / "native"))
    repo, spec3, _ = load_model(str(tmp_path / "repo"), dtype="bfloat16")
    assert spec2 == spec and ranks2 == ranks
    # config.json carries no sliding pattern; without a window it is moot
    assert spec.sliding_window == 0
    assert dataclasses.replace(spec3, sliding_pattern=spec.sliding_pattern) == spec
    ids = torch.randint(0, 128, (2, 9), generator=torch.Generator().manual_seed(1))
    want = generate_on_device(params, spec, ids.numpy(), max_new_tokens=6, use_pallas=True)
    for p in (native, repo):
        for layer, ref in zip(p["layers"], params["layers"]):
            for key, leaf in ref.items():
                for k, t in leaf.items():
                    if t is not None:
                        assert layer[key][k].device == t.device
                        assert layer[key][k].dtype == t.dtype and torch.equal(layer[key][k], t)
        got = generate_on_device(p, spec, ids.numpy(), max_new_tokens=6, use_pallas=True)
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_step_graph_captures_with_the_collector_off(cuda):
    """The cyclic garbage collector is off while a step is captured and on
    again after (its warm-up runs with it on): a dead decoder collected
    inside a capture would destroy its own graph there, which invalidates
    the capture (cudaErrorStreamCaptureInvalidated). The replays count."""
    import gc

    from asvd4llm_tpu_torch.utils.graphs import StepGraph

    seen = []
    x = torch.zeros(4, device=cuda)

    def step():
        seen.append(gc.isenabled())
        x.add_(1)
    assert gc.isenabled()
    g = StepGraph(step, [x])
    g.replay(3)
    torch.cuda.synchronize()
    assert seen == [True, False] and gc.isenabled() and float(x[0]) == 3
    # with the collector off before, it stays off after
    gc.disable()
    try:
        StepGraph(step, [x])
        assert not gc.isenabled()
    finally:
        gc.enable()
