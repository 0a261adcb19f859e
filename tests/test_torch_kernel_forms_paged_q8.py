"""What the redesigned forms of kernels 6 and 3 compute, checked on the CPU.

Kernel 6's split form (csrc/paged_latent_attention.cu, "split_wgmma") loads
each 128-key chunk's latent rows from the page pools in TMA boxes
(`split_boxes`), keeps each chunk's max, denominator and T(p)·tv sum and
combines the chunks afterwards. Its plain version,
`paged_latent_split_reference`, is held here against the JAX package's
`_paged_latent_core` (the Pallas kernel in interpret mode) at page sizes
8, 16, 64 and 256; the box decomposition is held against the live keys
directly. Kernel 3's tiled form ("wgmma_tiled", csrc/gemm_sm90.cuh
`gemm_nt_i8`) fuses the row sums of x and of the rounded t into the
passes that stream them; `fused_lowrank_q8_tiled_model` is that arithmetic,
held against the JAX `fused_lowrank_apply_q8` (interpret mode) and the
port's plain version. The `_form` helpers must pick the new forms at the
shapes `chip_smoke.py` drives and the earlier forms at the edges. The
serving engine with the kernels pads the ranks of a model to multiples of
8 before it builds its pools, which must change no token. The CUDA kernels
themselves are held against the plain versions on a card by
tests/test_torch_cuda.py.

Tolerances: f32 atol/rtol 1e-4 (sums in another order); bf16 2e-2 (p is
rounded to bf16 relative to its chunk's max instead of a running max, and
t once to bf16: one rounding either way).
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from asvd4llm_tpu.ops import pallas_lowrank as jpl  # noqa: E402
from asvd4llm_tpu.ops.pallas_latent_attention import (  # noqa: E402
    _paged_latent_core as j_paged_core,
)
from asvd4llm_tpu.ops.quant import QuantParams as JQuantParams  # noqa: E402
from asvd4llm_tpu.serving import engine as jeng  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq  # noqa: E402
from asvd4llm_tpu_torch.ops import paged_attention as pa  # noqa: E402
from asvd4llm_tpu_torch.serving import engine as teng  # noqa: E402
from test_torch_decoder import BASE, both_specs, random_tree  # noqa: E402

CHUNK = pa.SPLIT_KEYS

# ------------------------------------------------ kernel 6, split form ----

PAGED_SPLIT_CASES = {
    # name: (P, MP, KV, rep, positions, softcap, sliding)
    "p8_mha": (8, 36, 2, 1, (287, 0, 130), 0.0, 0),
    "p16_softcap_sliding": (16, 18, 2, 2, (200, 0, 127), 5.0, 50),
    "p64_gqa4": (64, 5, 1, 4, (319, 0, 128), 0.0, 0),
    "p256_sliding": (256, 2, 2, 2, (511, 0, 255), 0.0, 140),
}


def _paged_inputs(seed, P, MP, KV, rep, positions, hd=16, Rk=24, Rv=16):
    """Shuffled pages; row 1 an idle slot (page table all 0, position 0)."""
    rng = np.random.RandomState(seed)
    B, H = len(positions), KV * rep
    n_pages = 1 + B * MP
    pt = (rng.permutation(n_pages - 1) + 1).reshape(B, MP).astype(np.int32)
    pt[1] = 0
    f = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)  # noqa: E731
    fr = np.arange(MP * P, dtype=np.float32)[:, None] * (
        1.0 / 10000.0 ** (np.arange(0, hd, 2, dtype=np.float32) / hd))[None, :]
    emb = np.concatenate([fr, fr], axis=-1)
    return dict(q=f(B, H, hd) * 2, tk=f(n_pages, P, Rk), tv=f(n_pages, P, Rv),
                a_k=f(KV * hd, Rk) * Rk ** -0.5, cos=np.cos(emb), sin=np.sin(emb), pt=pt,
                positions=np.asarray(positions, np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PAGED_SPLIT_CASES))
def test_paged_split_reference_matches_pallas_core(case, dtype):
    """Per 128-key chunk (max, den, T(p)·tv) through the page table, then
    the combine, equals the TPU kernel's online softmax over the pages."""
    P, MP, KV, rep, positions, cap, sw = PAGED_SPLIT_CASES[case]
    d = _paged_inputs(P + MP, P, MP, KV, rep, positions)
    hd = d["q"].shape[2]
    kw = dict(scale=hd ** -0.5, softcap=cap, sliding=sw, kv_heads=KV)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(j_paged_core(
        jnp.asarray(d["q"]), *(jnp.asarray(d[k]).astype(jdt) for k in ("tk", "tv", "a_k")),
        jnp.asarray(d["cos"]), jnp.asarray(d["sin"]), jnp.asarray(d["pt"]),
        jnp.asarray(d["positions"]), head_dim=hd, interpret=True, **kw)).astype(np.float32)
    tdt = getattr(torch, dtype)
    out = pa.paged_latent_split_reference(
        torch.from_numpy(d["q"]), *(torch.from_numpy(d[k]).to(tdt) for k in ("tk", "tv", "a_k")),
        torch.from_numpy(d["cos"]), torch.from_numpy(d["sin"]), torch.from_numpy(d["pt"]),
        torch.from_numpy(d["positions"]), **kw)
    assert out.shape == ref.shape and out.dtype == torch.float32
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("P", [8, 16, 64, 128, 256, 512])
@pytest.mark.parametrize("sliding", [0, 100])
def test_split_boxes_cover_exactly_the_live_keys(P, sliding):
    """Chunks x boxes: each chunk's boxes tile its 128 stage rows; every
    box reads rows of one live page of the row; every live key is loaded
    from its own page slot in exactly one box of its own chunk; a chunk is
    launched (not marked empty) exactly when it holds a live key."""
    MP = max(2, 768 // P)
    for pos in sorted({0, P - 1, P, 127, 128, 300, MP * P - 1}):
        if pos >= MP * P:
            continue
        t_lo = max(0, pos - sliding + 1) if sliding > 0 else 0
        live = set(range(t_lo, pos + 1))
        boxes = pa.split_boxes(P, MP, pos, sliding)
        loaded = []
        for j in range(-(-MP * P // CHUNK)):
            chunk_keys = set(range(j * CHUNK, (j + 1) * CHUNK))
            assert (j in boxes) == bool(chunk_keys & live), (pos, j)
            if j not in boxes:
                continue
            r = 0
            for r0, n, lp, rp in boxes[j]:
                assert r0 == r and n == min(P, CHUNK)
                assert t_lo // P <= lp <= pos // P and 0 <= rp and rp + n <= P
                r += n
                # stage rows r0..r0+n hold keys c0+r0..; real data where the
                # page slot loaded is the key's own
                loaded += [j * CHUNK + r0 + i for i in range(n) if lp * P + rp + i == j * CHUNK + r0 + i]
            assert r == CHUNK
        assert sorted(k for k in loaded if k in live) == sorted(live)
        assert len(set(loaded)) == len(loaded)


@pytest.mark.parametrize("dtype,hd,Rk,Rv,P,aligned,want", [
    (torch.bfloat16, 128, 1024, 1024, 256, True, "split_wgmma"),   # the smoke's shapes
    (torch.bfloat16, 128, 824, 416, 256, True, "split_wgmma"),     # the "kv" serve run, padded
    (torch.bfloat16, 128, 819, 409, 256, True, "tile32"),          # the same, as they were
    (torch.bfloat16, 64, 512, 3072, 8, True, "split_wgmma"),
    (torch.bfloat16, 128, 256, 192, 512, True, "split_wgmma"),
    (torch.bfloat16, 128, 256, 192, 4, True, "tile32"),            # page under 8 rows
    (torch.bfloat16, 128, 256, 192, 24, True, "tile32"),           # not a power of two
    (torch.bfloat16, 128, 100, 72, 16, True, "tile32"),            # Rk not a multiple of 8
    (torch.bfloat16, 128, 96, 76, 16, True, "tile32"),             # Rv not a multiple of 8
    (torch.bfloat16, 256, 256, 256, 16, True, "tile32"),
    (torch.bfloat16, 32, 256, 256, 16, True, "tile32"),
    (torch.bfloat16, 128, 256, 256, 16, False, "tile32"),          # pools not 16-byte aligned
    (torch.float32, 128, 1024, 1024, 256, True, "tile32"),
])
def test_kernel6_form_dispatch(dtype, hd, Rk, Rv, P, aligned, want):
    assert pa._latent_form(dtype, hd, Rk, Rv, P, aligned) == want


# ------------------------------------------------- kernel 3, tiled form ----

def _q8_case(seed, M, K, N, R, bias):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    a8 = rng.randint(-128, 128, (N, R)).astype(np.int8)
    b8 = rng.randint(-128, 128, (R, K)).astype(np.int8)
    asc, bsc = (rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32) / 128 for n in (N, R))
    azp, bzp = (rng.uniform(-20, 20, (n, 1)).astype(np.float32) for n in (N, R))
    bv = (rng.randn(N) * 0.1).astype(np.float32) if bias else None
    return x, a8, asc, azp, b8, bsc, bzp, bv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,R,bias", [
    (24, 384, 200, 72, True),     # R not a multiple of 64: a ragged last stage of t
    (17, 256, 130, 40, False),    # the smallest tiled-path M
    (64, 200, 96, 136, True),     # K not a multiple of 64: a ragged last stage of x
])
def test_q8_tiled_model_matches_jax_and_plain(M, K, N, R, bias, dtype):
    """Raw-code products, rowsum(x) from x's 64-column stages, B's
    correction and one rounding of t, rowsum(t) of the rounded t, A's
    correction and the bias: the JAX kernel's and the plain version's y."""
    x, a8, asc, azp, b8, bsc, bzp, bv = _q8_case(M + K + R, M, K, N, R, bias)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(jpl.fused_lowrank_apply_q8(
        jnp.asarray(x).astype(jdt), jnp.asarray(a8), JQuantParams(jnp.asarray(asc),
                                                                   jnp.asarray(azp), 255),
        jnp.asarray(b8), JQuantParams(jnp.asarray(bsc), jnp.asarray(bzp), 255),
        None if bv is None else jnp.asarray(bv).astype(jdt), interpret=True)).astype(np.float32)
    tdt = getattr(torch, dtype)
    T = torch.from_numpy
    args = (T(x).to(tdt), T(a8), T(asc), T(azp), T(b8), T(bsc), T(bzp),
            None if bv is None else T(bv).to(tdt))
    got = fq.fused_lowrank_q8_tiled_model(*args)
    plain = fq.fused_lowrank_q8_reference(*args)
    assert got.shape == (M, N) and got.dtype == tdt
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=tol, rtol=tol)


# (name, N, K, R) of chip_smoke.py's KERNEL1_SHAPES: Llama-2-7B at ratio 0.9
LLAMA2_7B_LINEARS = [("q_proj", 4096, 4096, 1920), ("gate_proj", 11008, 4096, 2688),
                     ("down_proj", 4096, 11008, 2688)]


@pytest.mark.parametrize("name,N,K,R", LLAMA2_7B_LINEARS)
@pytest.mark.parametrize("M,dtype,aligned,want", [
    (1024, torch.bfloat16, True, "wgmma_tiled"),     # the int8 run's windowed PPL eval
    (64, torch.bfloat16, True, "wgmma_tiled"),
    (17, torch.bfloat16, True, "wgmma_tiled"),
    (16, torch.bfloat16, True, "mma_skinny"),        # decode
    (4, torch.bfloat16, True, "mma_skinny"),
    (1024, torch.float32, True, "cuda_cores"),
    (1024, torch.bfloat16, False, "cuda_cores"),     # operands not 16-byte aligned
])
def test_kernel3_form_dispatch(name, N, K, R, M, dtype, aligned, want):
    assert fq._form_q8(M, K, R, K, R, dtype, aligned) == want


@pytest.mark.parametrize("M,K,R,ldb,lda,want", [
    (1024, 4096, 1920, 4096, 2048, "wgmma_tiled"),   # codes padded (wider rows)
    (1024, 4096, 819, 4096, 819, "wmma_tiled"),      # a rank not a multiple of 8
    (1024, 4096, 824, 4096, 824, "wmma_tiled"),      # A8 rows not 16-byte aligned
    (1024, 4096, 832, 4096, 832, "wgmma_tiled"),
    (1024, 264, 64, 264, 64, "cuda_cores"),          # K not a multiple of 16
    (1024, 256, 64, 264, 64, "cuda_cores"),          # B8 rows not 16-byte aligned
    (4, 4096, 819, 4096, 819, "mma_skinny"),
])
def test_kernel3_form_dispatch_code_rows(M, K, R, ldb, lda, want):
    assert fq._form_q8(M, K, R, ldb, lda, torch.bfloat16) == want


# ----------------------------------------- the engine pads ranks to 8 ----

@pytest.fixture(scope="module")
def unaligned_model():
    """A 2-layer Llama whose low-rank leaves have ranks 5 and 10, not
    multiples of 8 (layer 0's k and v: latent pools in modes "v" and
    "kv")."""
    jspec, tspec = both_specs("llama_spec", **dict(
        BASE, num_heads=4, num_kv_heads=2, head_dim=8, norm_eps=1e-5))
    tree = random_tree(jspec, seed=5, lowrank=((0, "k_proj"), (0, "v_proj"),
                                               (0, "q_proj"), (1, "down_proj")))
    return jspec, tspec, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, tspec)


@pytest.mark.parametrize("mode", [False, "v", "kv"])
def test_engine_with_kernels_pads_ranks_and_keeps_tokens(unaligned_model, mode):
    """PagedEngine(use_pallas=True) builds its latent pools at ranks padded
    to multiples of 8 and emits the JAX engine's tokens (f32)."""
    jspec, tspec, jp, tp = unaligned_model
    kw = dict(latent=mode, max_batch=2, page_size=8, num_pages=32, max_pages_per_seq=4)
    rng = np.random.RandomState(1)
    prompts, budgets = [rng.randint(0, 96, (n,)) for n in (5, 13, 9)], [8, 5, 7]

    def serve(eng):
        rids = [eng.add_request(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
        eng.run()
        return [eng.result(r).tolist() for r in rids]
    want = serve(jeng.PagedEngine(jp, jspec, use_pallas=False, **kw))
    eng = teng.PagedEngine(tp, tspec, use_pallas=True, **kw)
    widths = [v.shape[-1] for p in eng.pools for k, v in p.items() if k in ("tk", "tv")]
    assert len(widths) == {False: 0, "v": 1, "kv": 2}[mode]
    assert all(w % 8 == 0 for w in widths)
    assert tp["layers"][0]["k_proj"]["A"].shape[1] % 8   # the caller's params are kept
    got = serve(eng)
    assert got == want and [len(t) for t in got] == budgets
