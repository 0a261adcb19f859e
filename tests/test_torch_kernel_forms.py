"""What the redesigned kernel forms compute, checked on the CPU.

Kernel 2's split form (csrc/latent_attention.cu, "split_wgmma") cuts the
keys into chunks, keeps each chunk's max, denominator and T(p)·tv sum, and
combines the chunks afterwards. Its plain version,
`latent_attention_split_reference`, is held here against the JAX package's
`_latent_attention_core` (the Pallas kernel in interpret mode), including
chunks that hold no live key (the kernel launches every chunk of T). The `_form` helpers of the kernel 1 and 2
wrappers must pick the new forms at the shapes `chip_smoke.py` drives and
the earlier forms for f32 and unaligned shapes. `align_ranks` pads the
ranks of a model to multiples of 8 for the new forms, which must change no
result: the padded factors and caches give the plain versions' values, and
greedy decoding with them emits the JAX package's tokens. The CUDA kernels
themselves are held against the plain versions on a card by
tests/test_torch_cuda.py.

Tolerances: f32 atol/rtol 1e-4, as tests/test_torch_kernels.py (the softmax
is summed in another order); bf16 2e-2 (p is rounded to bf16 relative to
its chunk's max instead of the running max: one rounding either way).
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from asvd4llm_tpu.models.decoder import rope_cos_sin  # noqa: E402
from asvd4llm_tpu.ops.pallas_latent_attention import (  # noqa: E402
    _latent_attention_core as j_core,
)
from asvd4llm_tpu.eval import generate as jgen  # noqa: E402
from asvd4llm_tpu_torch.eval import generate as tgen  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from asvd4llm_tpu_torch.ops import fused_lowrank as fl  # noqa: E402
from asvd4llm_tpu_torch.ops import latent_attention as la  # noqa: E402
from asvd4llm_tpu_torch.ops.lowrank import align_ranks, lowrank_apply, pad_rank  # noqa: E402
from test_torch_decoder import BASE, both_specs, random_tree  # noqa: E402

SPLIT_CASES = {
    # name: (B, H, KV, hd, T, Rk, Rv, pos, softcap, sliding, chunk)
    "mha_4_chunks": (2, 4, 4, 16, 128, 24, 20, 127, 0.0, 0, 32),
    "gqa4_chunks_past_pos": (2, 8, 2, 16, 128, 24, 20, 70, 0.0, 0, 32),
    "sliding_empties_chunks": (1, 4, 2, 16, 128, 16, 12, 120, 0.0, 20, 32),
    "softcap_ragged_chunk": (2, 4, 1, 16, 96, 24, 20, 90, 30.0, 0, 40),
    # the kernel's chunk, the first chunk before the window
    "kernel_chunk_window": (1, 4, 2, 16, 384, 24, 20, 300, 0.0, 100, la.SPLIT_KEYS),
}


def _inputs(seed, B, H, KV, hd, T, Rk, Rv):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, hd).astype(np.float32)
    tk = (rng.randn(B, T, Rk) * 0.3).astype(np.float32)
    tv = (rng.randn(B, T, Rv) * 0.3).astype(np.float32)
    a_k = (rng.randn(KV * hd, Rk) * 0.2).astype(np.float32)
    cos, sin = (np.array(c) for c in rope_cos_sin(jnp.arange(T), hd, 10000.0))
    return q, tk, tv, a_k, cos, sin


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_reference_matches_pallas_core(case):
    """The per-chunk (max, den, numerator) + combine of the split form
    equals the TPU kernel's online softmax; chunks past pos or before the
    sliding window have den = 0 and drop out of the combine."""
    B, H, KV, hd, T, Rk, Rv, pos, cap, sw, chunk = SPLIT_CASES[case]
    q, tk, tv, a_k, cos, sin = _inputs(len(case), B, H, KV, hd, T, Rk, Rv)
    kw = dict(scale=hd ** -0.5, softcap=cap, sliding=sw, kv_heads=KV)
    ref = np.asarray(j_core(*(jnp.asarray(v) for v in (q, tk, tv, a_k, cos, sin)), pos,
                            head_dim=hd, tt=32, interpret=True, **kw))
    out = la.latent_attention_split_reference(
        *(torch.from_numpy(v) for v in (q, tk, tv, a_k, cos, sin)), pos, chunk=chunk, **kw)
    assert out.shape == (B, H, Rv) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_split_reference_matches_pallas_core_bf16():
    B, H, KV, hd, T, Rk, Rv, pos = 2, 4, 2, 16, 128, 24, 20, 100
    q, tk, tv, a_k, cos, sin = _inputs(7, B, H, KV, hd, T, Rk, Rv)
    kw = dict(scale=hd ** -0.5, softcap=0.0, sliding=0, kv_heads=KV)
    ref = np.asarray(j_core(*(jnp.asarray(v).astype(jnp.bfloat16) for v in (q, tk, tv, a_k)),
                            jnp.asarray(cos), jnp.asarray(sin), pos, head_dim=hd, tt=32,
                            interpret=True, **kw)).astype(np.float32)
    out = la.latent_attention_split_reference(
        *(torch.from_numpy(v).bfloat16() for v in (q, tk, tv, a_k)), torch.from_numpy(cos),
        torch.from_numpy(sin), pos, chunk=32, **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2, rtol=2e-2)


# (name, N, K, R) of chip_smoke.py's KERNEL1_SHAPES: Llama-2-7B at ratio 0.9
LLAMA2_7B_LINEARS = [
    ("q_proj", 4096, 4096, 1920), ("gate_proj", 11008, 4096, 2688),
    ("down_proj", 4096, 11008, 2688),
]


@pytest.mark.parametrize("name,N,K,R", LLAMA2_7B_LINEARS)
@pytest.mark.parametrize("M,dtype,aligned,want", [
    (1024, torch.bfloat16, True, "wgmma_tiled"),     # the windowed PPL eval
    (64, torch.bfloat16, True, "wgmma_tiled"),
    (17, torch.bfloat16, True, "wgmma_tiled"),
    (16, torch.bfloat16, True, "mma_skinny"),        # decode
    (4, torch.bfloat16, True, "mma_skinny"),
    (1024, torch.float32, True, "cuda_cores"),
    (4, torch.float32, True, "cuda_cores"),
    (1024, torch.bfloat16, False, "cuda_cores"),     # rows not 16-byte aligned
])
def test_kernel1_form_dispatch(name, N, K, R, M, dtype, aligned, want):
    assert fl._form(M, K, R, dtype, aligned) == want


@pytest.mark.parametrize("M,K,R,want", [
    (1024, 4096, 819, "wmma_tiled"),     # the KV-target run's ranks, as they are
    (1024, 4096, 409, "wmma_tiled"),
    (1024, 4096, 824, "wgmma_tiled"),    # the same, padded by align_ranks
    (1024, 4096, 416, "wgmma_tiled"),
    (4, 4096, 819, "mma_skinny"),
    (1024, 300, 64, "cuda_cores"),       # K not a multiple of 8
])
def test_kernel1_form_dispatch_unaligned_ranks(M, K, R, want):
    assert fl._form(M, K, R, torch.bfloat16) == want


@pytest.mark.parametrize("dtype,hd,Rk,Rv,aligned,want", [
    (torch.bfloat16, 128, 1024, 1024, True, "split_wgmma"),   # the smoke's mha shape
    (torch.bfloat16, 128, 1024, 768, True, "split_wgmma"),    # gqa4
    (torch.bfloat16, 128, 819, 409, True, "tile32"),          # KV-target ranks
    (torch.bfloat16, 128, 824, 416, True, "split_wgmma"),     # the same, padded
    (torch.bfloat16, 64, 96, 72, True, "split_wgmma"),
    (torch.bfloat16, 256, 1024, 1024, True, "tile32"),
    (torch.bfloat16, 32, 64, 64, True, "tile32"),
    (torch.bfloat16, 128, 1024, 1024, False, "tile32"),
    (torch.float32, 128, 1024, 1024, True, "tile32"),
])
def test_kernel2_form_dispatch(dtype, hd, Rk, Rv, aligned, want):
    assert la._form(dtype, hd, Rk, Rv, aligned) == want


@pytest.mark.parametrize("R", [1, 10, 16, 819])
@pytest.mark.parametrize("bias", [True, False])
def test_pad_rank_is_exact(R, bias):
    """Zero rows of B and zero columns of A: the same y from both the plain
    low-rank path and the kernel's plain version, t's added columns 0."""
    rng = np.random.RandomState(R)
    N, K, M = 48, 40, 6
    a = torch.from_numpy(rng.randn(N, R).astype(np.float32))
    b = torch.from_numpy(rng.randn(R, K).astype(np.float32))
    bv = torch.from_numpy(rng.randn(N).astype(np.float32)) if bias else None
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32))
    leaf = {"A": a, "B": b, "b": bv}
    pad = pad_rank(leaf)
    R8 = -(-R // 8) * 8
    assert pad["A"].shape == (N, R8) and pad["B"].shape == (R8, K)
    assert pad["b"] is bv and (pad is leaf) == (R == R8)
    assert not pad["A"][:, R:].any() and not pad["B"][R:].any()
    for fn in (lambda lf: lowrank_apply(x, lf["A"], lf["B"], bv),
               lambda lf: fl.fused_lowrank_reference(x, lf["A"], lf["B"], bv)):
        np.testing.assert_allclose(fn(pad).numpy(), fn(leaf).numpy(), atol=1e-5, rtol=1e-5)


def test_padded_latent_caches_give_the_same_attention():
    """Caches and A_k zero-padded to ranks of a multiple of 8: the kernel's
    plain version gives the same s, and 0 in the added Rv columns."""
    B, H, KV, hd, T, Rk, Rv, pos = 2, 4, 2, 16, 40, 13, 11, 37
    q, tk, tv, a_k, cos, sin = (torch.from_numpy(v) for v in
                                _inputs(3, B, H, KV, hd, T, Rk, Rv))
    kw = dict(scale=hd ** -0.5, softcap=0.0, sliding=0, kv_heads=KV)
    want = la._latent_attention_core(q, tk, tv, a_k, cos, sin, pos, **kw)
    pk, pv, pa = (torch.nn.functional.pad(t, (0, -t.shape[-1] % 8)) for t in (tk, tv, a_k))
    assert la._form(torch.bfloat16, 128, pk.shape[-1], pv.shape[-1]) == "split_wgmma"
    got = la._latent_attention_core(q, pk, pv, pa, cos, sin, pos, **kw)
    assert got.shape == (B, H, 16) and not got[..., Rv:].any()
    np.testing.assert_allclose(got[..., :Rv].numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def unaligned_model():
    """A 2-layer Llama whose low-rank leaves have ranks 5 and 10, not
    multiples of 8 (layer 0's k and v: latent caches in mode "kv")."""
    jspec, tspec = both_specs("llama_spec", **dict(
        BASE, num_heads=4, num_kv_heads=2, head_dim=8, norm_eps=1e-5))
    tree = random_tree(jspec, seed=5, lowrank=((0, "k_proj"), (0, "v_proj"),
                                               (0, "q_proj"), (1, "down_proj")))
    return jspec, tspec, tree, params_from_numpy(tree, tspec)


def test_align_ranks_pads_low_rank_leaves_only(unaligned_model):
    _, tspec, _, tp = unaligned_model
    padded = align_ranks(tp, tspec)
    for i, key in ((0, "k_proj"), (0, "v_proj"), (0, "q_proj"), (1, "down_proj")):
        R = tp["layers"][i][key]["A"].shape[1]
        assert R % 8                                  # 5 or 10: the given leaf is kept
        assert padded["layers"][i][key]["A"].shape[1] == 8 * -(-R // 8)
        assert padded["layers"][i][key]["B"].shape[0] == 8 * -(-R // 8)
    assert padded["layers"][0]["o_proj"] is tp["layers"][0]["o_proj"]
    assert padded["embed_tokens"] is tp["embed_tokens"]
    caches = tgen.init_caches(padded, tspec, 2, 8, torch.float32, latent="kv")
    assert caches[0]["tk"].shape == (2, 8, 8) and caches[0]["tv"].shape == (2, 8, 8)


@pytest.mark.parametrize("latent_kv", [False, True])
def test_generate_with_padded_ranks_matches_jax(unaligned_model, latent_kv):
    """generate(use_pallas=True) pads the ranks first; its tokens are the
    JAX package's plain-path tokens and the port's unpadded plain path's."""
    import jax
    jspec, tspec, tree, tp = unaligned_model
    ids = np.random.RandomState(9).randint(0, 96, (2, 7))
    jp = jax.tree.map(jnp.asarray, tree)
    ref = np.asarray(jgen.generate(jp, jspec, ids, max_new_tokens=6, latent_kv=latent_kv))
    got = tgen.generate(tp, tspec, ids, max_new_tokens=6, latent_kv=latent_kv,
                        use_pallas=True)
    plain = tgen.generate(tp, tspec, ids, max_new_tokens=6, latent_kv=latent_kv)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(plain, ref)
