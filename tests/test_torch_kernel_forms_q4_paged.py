"""What the redesigned forms of kernels 4 and 5 compute, and the int8 rank
padding, checked on the CPU.

Kernel 4's tiled form (csrc/fused_lowrank_q4.cu, "wgmma_tiled") streams
each factor's packed bytes in 64-byte stages whose low and high nibbles
are two 64-column halves of a 512-column pack tile, dequantizes each half
to bf16 (code·scale − zero_scale in f32, one rounding) and sums the
products in f32; `fused_lowrank_q4_tiled_model` is that arithmetic, held
here against the JAX package's `fused_lowrank_apply_q4` (the Pallas kernel
in interpret mode). Kernel 5's split form (csrc/paged_dense_attention.cu,
"split_tma") loads each 64-key chunk's rows from the page pools in TMA
boxes (`split_boxes(..., chunk=64)`), keeps each chunk's max, denominator
and T(p)·V sum per head, and combines the chunks
afterwards; its plain version `paged_dense_split_reference` is held against
the JAX package's `_paged_dense_core` (interpret mode) for dense V and
V-latent at page sizes 8, 64 and 256. The `_form` helpers must pick the new
forms at the shapes `chip_smoke.py` drives and the earlier forms at the
edges. `align_ranks` pads int8 leaves to ranks that are multiples of 16,
exactly. The CUDA kernels themselves are held against the plain versions
on a card by tests/test_torch_cuda.py.

Tolerances: f32 1e-5 for kernel 4 (sums in another order), 1e-4 for
kernel 5 (as in tests/test_torch_kernel_forms_paged_q8.py); bf16 for kernel 4
six standard deviations of the rounding error propagated through both
products (the JAX kernel dequantizes in bf16 arithmetic, four roundings a
weight, the port in f32 with one; each rounding an independent error within
its half-ulp), plus one ulp of t and of y for a rounding that flips; bf16
2e-2 for kernel 5 (p is rounded to bf16 relative to its chunk's max instead
of the row's); the int8 padding exact up to 1e-6 in f32.
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
    _paged_dense_core as j_dense_core,
)
from asvd4llm_tpu_torch.models import decoder as tdec  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from asvd4llm_tpu_torch.models.registry import (  # noqa: E402
    is_lowrank, is_q4_lowrank, is_q8_lowrank, iter_linears,
)
from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq  # noqa: E402
from asvd4llm_tpu_torch.ops import paged_attention as pa  # noqa: E402
from asvd4llm_tpu_torch.ops import quant as tq  # noqa: E402
from asvd4llm_tpu_torch.ops import quant_apply as tqa  # noqa: E402
from asvd4llm_tpu_torch.ops.lowrank import align_ranks, pad_rank  # noqa: E402
from test_torch_decoder import BASE, both_specs, random_tree  # noqa: E402

CHUNK = pa.DENSE_SPLIT_KEYS


# ------------------------------------------- int8 leaves in align_ranks ----

@pytest.fixture(scope="module")
def q8_model():
    """A 2-layer Llama with low-rank leaves of ranks 5 and 10 (not multiples
    of 8 or 16), deployed as int8 factors, plus one as it was and one as
    packed int4 factors."""
    _, tspec = both_specs("llama_spec", **dict(
        BASE, num_heads=4, num_kv_heads=2, head_dim=8, norm_eps=1e-5))
    tree = random_tree(_, seed=11, lowrank=((0, "k_proj"), (0, "q_proj"), (1, "down_proj"),
                                            (1, "o_proj")))
    params = params_from_numpy(tree, tspec)
    q8 = tqa.quantize_lowrank_factors_int8(params, tspec)
    return tspec, params, q8


def _leaves(params, spec):
    return dict(iter_linears(params, spec, include_extras=True))


def test_align_ranks_pads_q8_leaves_to_16(q8_model):
    """Every int8 leaf comes out with a rank that is a multiple of 16 (A8
    code rows 16 bytes apart); the caller's params are not changed."""
    spec, _, q8 = q8_model
    before = {n: leaf["Bsc"].shape[0] for n, leaf in _leaves(q8, spec).items()
              if is_q8_lowrank(leaf)}
    assert before and all(r % 16 for r in before.values())
    out = align_ranks(q8, spec)
    for name, leaf in _leaves(out, spec).items():
        if not is_q8_lowrank(leaf):
            continue
        R, Rp = before[name], leaf["Bsc"].shape[0]
        assert Rp % 16 == 0 and Rp - R < 16
        assert leaf["A8"].shape[1] == Rp and leaf["B8"].shape[0] == Rp
        assert leaf["Bzp"].shape == leaf["Bsc"].shape
        assert not leaf["A8"][:, R:].any() and not leaf["B8"][R:].any()
        assert not leaf["Bsc"][R:].any() and not leaf["Bzp"][R:].any()
    assert {n: leaf["Bsc"].shape[0] for n, leaf in _leaves(q8, spec).items()
            if is_q8_lowrank(leaf)} == before


def test_align_ranks_keeps_bf16_and_q4_leaves(q8_model):
    """{A, B} leaves still pad to multiples of 8; packed int4 leaves (ranks
    already padded to 512 at quantization) come back unchanged."""
    spec, params, _ = q8_model
    out = align_ranks(params, spec)
    for name, leaf in _leaves(out, spec).items():
        if is_lowrank(leaf):
            R = _leaves(params, spec)[name]["A"].shape[1]
            assert leaf["A"].shape[1] == -(-R // 8) * 8
    q4 = tqa.quantize_lowrank_factors_int4(params, spec, group=16, awq_fold=False)
    out4 = align_ranks(q4, spec)
    for name, leaf in _leaves(q4, spec).items():
        if is_q4_lowrank(leaf):
            assert _leaves(out4, spec)[name] is leaf


def test_padded_q8_leaf_is_exact_through_the_plain_path(q8_model):
    """The padded leaf gives the unpadded leaf's output through the plain
    version, the tiled form's model and the whole forward (f32)."""
    spec, _, q8 = q8_model
    rng = np.random.RandomState(3)
    padded = align_ranks(q8, spec)
    for name, leaf in _leaves(q8, spec).items():
        if not is_q8_lowrank(leaf):
            continue
        p = _leaves(padded, spec)[name]
        x = torch.from_numpy(rng.randn(24, leaf["B8"].shape[1]).astype(np.float32))

        def args(lf):
            return (x, lf["A8"], lf["Asc"], lf["Azp"], lf["B8"], lf["Bsc"], lf["Bzp"], lf["b"])
        want = fq.fused_lowrank_q8_reference(*args(leaf))
        for fn in (fq.fused_lowrank_q8_reference, fq.fused_lowrank_q8_tiled_model):
            torch.testing.assert_close(fn(*args(p)), want, atol=1e-6, rtol=1e-6)
    ids = torch.from_numpy(rng.randint(0, spec.vocab_size, (2, 9)))
    torch.testing.assert_close(tdec.forward(padded, ids, spec, use_pallas=True),
                               tdec.forward(q8, ids, spec, use_pallas=True),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name,N,K,R", [("k_proj", 4096, 4096, 819),
                                        ("v_proj", 4096, 4096, 409)])
def test_padded_q8_rank_takes_the_wgmma_form(name, N, K, R):
    """The KV-target run's ranks at the CLI's default rank_align: as they
    are, kernel 3 runs `wmma_tiled` at M = 1024; padded by pad_rank, the
    wgmma form."""
    leaf = {"A8": torch.zeros(N, R, dtype=torch.int8), "Asc": torch.ones(N, 1),
            "Azp": torch.zeros(N, 1), "B8": torch.zeros(R, K, dtype=torch.int8),
            "Bsc": torch.ones(R, 1), "Bzp": torch.zeros(R, 1), "b": None}
    assert fq._form_q8(1024, K, R, K, R, torch.bfloat16) == "wmma_tiled"
    p = pad_rank(leaf)
    Rp = p["Bsc"].shape[0]
    assert Rp == -(-R // 16) * 16
    assert fq._form_q8(1024, K, Rp, p["B8"].shape[1], p["A8"].shape[1],
                       torch.bfloat16) == "wgmma_tiled"
    assert fq._form_q8(4, K, Rp, p["B8"].shape[1], p["A8"].shape[1],
                       torch.bfloat16) == "mma_skinny"


# ------------------------------------------------- kernel 4, tiled form ----

def _q4_case(seed, M, K, N, R, group, bias):
    """x and packed int4 factors quantized by the port (its layout is the JAX
    package's byte for byte; B4's rows padded to Rp, as
    quantize_lowrank_factors_int4 pads them), as numpy."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(M, K) * 0.5).astype(np.float32)
    a4, asc, azs = (v.numpy() for v in tq.quantize_to_int4_grouped(
        torch.from_numpy(rng.randn(N, R) * R ** -0.5).float(), group=group))
    b4, bsc, bzs = (v.numpy() for v in tq.quantize_to_int4_grouped(
        torch.from_numpy(rng.randn(R, K) * K ** -0.5).float(), group=group))
    rp = a4.shape[1] * 2 - R
    b4, bsc, bzs = (np.pad(v, ((0, rp), (0, 0))) for v in (b4, bsc, bzs))
    bv = (rng.randn(N) * 0.1).astype(np.float32) if bias else None
    return x, [a4, asc, azs, b4, bsc, bzs], bv


HALF_ULP = 2.0 ** -8   # bf16's rounding error at most, relative to the value


def _dq_error(packed, scale, zscale, group, w):
    """Per weight [rows, cols of w], the root-sum-square of the half-ulps of
    the roundings by which the JAX kernel's bf16 dequantization (the scale
    to bf16, code·scale, the zero-scale to bf16, their difference) and the
    port's one rounding of the f32 value w can differ."""
    codes = tq.unpack_int4(torch.from_numpy(packed)).float().numpy()
    rep = lambda v: np.repeat(v, group, axis=1)[:, :w.shape[1]]  # noqa: E731
    cs, zs = codes[:, :w.shape[1]] * rep(scale), rep(zscale)
    return HALF_ULP * np.sqrt(2 * cs ** 2 + zs ** 2 + 2 * w ** 2)


def _q4_bf16_bound(x, q, group, ref):
    """A bound on |port − JAX| for y in bf16. Each rounding is an error
    uniform within its half-ulp (variance at most half-ulp²/3), so t's
    error before its rounding has the standard deviation
    sqrt(Σ_k x²·e_b²/3); a rounding of t that flips adds one ulp of t. y's
    error has sqrt(Σ_r σ_t²·a² + t²·e_a²/3), and the bound is six of
    those, plus one ulp of y."""
    K = x.shape[1]
    a, b = (v.float().numpy() for v in fq._q4_factors(
        *(torch.from_numpy(v) for v in q), group, K, torch.float32))
    e_b, e_a = _dq_error(*q[3:6], group, b), _dq_error(*q[0:3], group, a)
    xb = x.float().numpy()
    t = np.abs(xb @ b.T)
    var_t = (xb ** 2) @ (e_b ** 2).T / 3 + (2 * HALF_ULP * t) ** 2
    sd_y = np.sqrt(var_t @ (a ** 2).T + (t ** 2) @ (e_a ** 2).T / 3)
    return 6 * sd_y + 2 * HALF_ULP * np.abs(ref) + 1e-6


def _swap_halves(packed):
    """The packed bytes with their nibbles swapped: columns c and c + 256 of
    every pack tile trade places."""
    return ((packed & 15) << 4) | (packed >> 4)


Q4_MODEL_CASES = [  # (M, K, N, R, group, bias)
    (17, 512, 130, 100, 128, True),     # the smallest tiled M; Rp = 512
    (40, 1000, 96, 600, 64, False),     # K < Kp = 1024; two pack tiles of rank
    (64, 512, 136, 200, 32, True),      # group 32: two scale changes a half
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,R,group,bias", Q4_MODEL_CASES)
def test_q4_tiled_model_matches_jax(M, K, N, R, group, bias, dtype):
    """The half-step sums of dequantized bf16 tiles: the JAX kernel's y
    (f32 within 1e-5; bf16 within six standard deviations of the rounding
    error, a bound that an output of zeros or a model with the nibble
    halves swapped fails)."""
    x, q, bv = _q4_case(M + K + R + group, M, K, N, R, group, bias)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jb = None if bv is None else jnp.asarray(bv).astype(jdt)
    ref = np.asarray(jpl.fused_lowrank_apply_q4(
        jnp.asarray(x).astype(jdt), *(jnp.asarray(v) for v in q), jb, group=group,
        interpret=True)).astype(np.float32)
    tdt = getattr(torch, dtype)
    T = torch.from_numpy
    args = (T(x).to(tdt), *(T(v) for v in q), None if bv is None else T(bv).to(tdt))
    got = fq.fused_lowrank_q4_tiled_model(*args, group=group)
    assert got.shape == (M, N) and got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
        return
    bound = _q4_bf16_bound(args[0], q, group, ref)
    err = np.abs(got - ref)
    assert (err <= bound).all(), float((err - bound).max())
    # the bound holds the bf16 semantics: most of y lies outside it for an
    # all-zero y or for the nibble halves read the wrong way round
    swapped = [_swap_halves(v) if i in (0, 3) else v for i, v in enumerate(q)]
    wrong = fq.fused_lowrank_q4_tiled_model(args[0], *(T(v) for v in swapped), args[7],
                                            group=group).float().numpy()
    for name, bad in (("zeros", np.zeros_like(ref)), ("swapped halves", wrong)):
        assert (np.abs(bad - ref) > bound).mean() > 0.5, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,R,group,bias", Q4_MODEL_CASES[:1] + [
    (24, 1024, 64, 40, 256, False),     # group 256
    (20, 512, 48, 520, 16, True),       # group 16: a new scale every 16 columns
])
def test_q4_tiled_model_matches_plain(M, K, N, R, group, bias, dtype):
    """The same weights rounded the same way as the plain version: only the
    order of the f32 sums differs."""
    x, q, bv = _q4_case(M + N, M, K, N, R, group, bias)
    tdt = getattr(torch, dtype)
    T = torch.from_numpy
    args = (T(x).to(tdt), *(T(v) for v in q), None if bv is None else T(bv).to(tdt))
    got = fq.fused_lowrank_q4_tiled_model(*args, group=group)
    want = fq.fused_lowrank_q4_reference(*args, group=group)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# (name, N, K, R) of chip_smoke.py's KERNEL1_SHAPES: Llama-2-7B at ratio 0.9
LLAMA2_7B_LINEARS = [("q_proj", 4096, 4096, 1920), ("gate_proj", 11008, 4096, 2688),
                     ("down_proj", 4096, 11008, 2688)]


@pytest.mark.parametrize("name,N,K,R", LLAMA2_7B_LINEARS)
@pytest.mark.parametrize("M,dtype,w_aligned,x_aligned,want", [
    (1024, torch.bfloat16, True, True, "wgmma_tiled"),   # the int4 run's PPL eval
    (17, torch.bfloat16, True, True, "wgmma_tiled"),
    (16, torch.bfloat16, True, True, "mma_skinny"),      # decode
    (4, torch.bfloat16, True, False, "mma_skinny"),
    (1024, torch.bfloat16, True, False, "wmma_tiled"),   # x not 16-byte aligned
    (1024, torch.float32, True, True, "cuda_cores"),
    (1024, torch.bfloat16, False, True, "cuda_cores"),   # codes not 16-byte aligned
])
def test_kernel4_form_dispatch(name, N, K, R, M, dtype, w_aligned, x_aligned, want):
    assert fq._form_q4(M, K, dtype, w_aligned, x_aligned) == want


@pytest.mark.parametrize("K,want", [(4096, "wgmma_tiled"), (1000, "wgmma_tiled"),
                                    (300, "wmma_tiled"), (129, "wmma_tiled")])
def test_kernel4_form_dispatch_x_width(K, want):
    """TMA needs x's rows 16 bytes apart: K a multiple of 8."""
    assert fq._form_q4(64, K, torch.bfloat16) == want


# ------------------------------------------------- kernel 5, split form ----

PAGED_DENSE_CASES = {
    # name: (P, MP, KV, rep, positions, softcap, sliding, Rv (0: dense V))
    "p8_mha_dense": (8, 20, 2, 1, (159, 0, 70), 0.0, 0, 0),
    "p8_gqa4_vlatent_softcap": (8, 12, 2, 4, (95, 0, 64), 5.0, 0, 24),
    "p64_gqa2_dense_sliding": (64, 3, 2, 2, (191, 0, 64), 0.0, 50, 0),
    "p64_mha16_vlatent_sliding": (64, 3, 16, 1, (150, 0, 63), 0.0, 70, 40),
    "p256_gqa4_dense_softcap": (256, 2, 1, 4, (511, 0, 300), 5.0, 0, 0),
    "p256_mha16_vlatent": (256, 2, 16, 1, (400, 0, 255), 0.0, 0, 16),
}


def _dense_inputs(seed, P, MP, KV, rep, positions, Rv, hd=16):
    """Shuffled pages; row 1 an idle slot (page table all 0, position 0)."""
    rng = np.random.RandomState(seed)
    B, H = len(positions), KV * rep
    n_pages = 1 + B * MP
    pt = (rng.permutation(n_pages - 1) + 1).reshape(B, MP).astype(np.int32)
    pt[1] = 0
    f = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)  # noqa: E731
    v = f(n_pages, P, Rv) if Rv else f(n_pages, P, KV, hd)
    return dict(q=f(B, H, hd) * 2, k=f(n_pages, P, KV, hd), v=v, pt=pt,
                positions=np.asarray(positions, np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PAGED_DENSE_CASES))
def test_paged_dense_split_reference_matches_pallas_core(case, dtype):
    """Per 64-key chunk and head block (max, den, T(p)·V) through the page
    table, then the combine, equals the TPU kernel's online softmax over the
    pages, for dense V and V-latent."""
    P, MP, KV, rep, positions, cap, sw, Rv = PAGED_DENSE_CASES[case]
    d = _dense_inputs(P + MP + Rv, P, MP, KV, rep, positions, Rv)
    hd = d["q"].shape[2]
    kw = dict(scale=hd ** -0.5, softcap=cap, sliding=sw, kv_heads=KV)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(j_dense_core(
        jnp.asarray(d["q"]), jnp.asarray(d["k"]).astype(jdt), jnp.asarray(d["v"]).astype(jdt),
        jnp.asarray(d["pt"]), jnp.asarray(d["positions"]), head_dim=hd, interpret=True,
        **kw)).astype(np.float32)
    tdt = getattr(torch, dtype)
    out = pa.paged_dense_split_reference(
        torch.from_numpy(d["q"]), torch.from_numpy(d["k"]).to(tdt),
        torch.from_numpy(d["v"]).to(tdt), torch.from_numpy(d["pt"]),
        torch.from_numpy(d["positions"]), **kw)
    assert out.shape == ref.shape and out.dtype == torch.float32
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("case", sorted(PAGED_DENSE_CASES))
def test_paged_dense_split_reference_matches_plain(case):
    """f32: the chunked schedule and the one-pass plain version agree."""
    P, MP, KV, rep, positions, cap, sw, Rv = PAGED_DENSE_CASES[case]
    d = {k: torch.from_numpy(v) for k, v in
         _dense_inputs(P, P, MP, KV, rep, positions, Rv).items()}
    kw = dict(scale=0.25, softcap=cap, sliding=sw, kv_heads=KV)
    args = (d["q"], d["k"], d["v"], d["pt"], d["positions"])
    torch.testing.assert_close(pa.paged_dense_split_reference(*args, **kw),
                               pa.paged_dense_reference(*args, **kw), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("P", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("sliding", [0, 100])
def test_dense_split_boxes_cover_exactly_the_live_keys(P, sliding):
    """64-key chunks x boxes: each chunk's boxes tile its 64 stage rows,
    each box of P rows (P < 64) or one 64-row box inside a page; every live
    key is loaded from its own page slot in exactly one box of its own
    chunk; a chunk is launched exactly when it holds a live key."""
    MP = max(2, 384 // P)
    for pos in sorted({0, P - 1, P, 63, 64, 200, MP * P - 1}):
        if pos >= MP * P:
            continue
        t_lo = max(0, pos - sliding + 1) if sliding > 0 else 0
        live = set(range(t_lo, pos + 1))
        boxes = pa.split_boxes(P, MP, pos, sliding, CHUNK)
        loaded = []
        for j in range(-(-MP * P // CHUNK)):
            assert (j in boxes) == bool(set(range(j * CHUNK, (j + 1) * CHUNK)) & live)
            if j not in boxes:
                continue
            r = 0
            for r0, n, lp, rp in boxes[j]:
                assert r0 == r and n == min(P, CHUNK)
                assert t_lo // P <= lp <= pos // P and rp + n <= P
                r += n
                loaded += [j * CHUNK + r0 + i for i in range(n)
                           if lp * P + rp + i == j * CHUNK + r0 + i]
            assert r == CHUNK
        assert sorted(k for k in loaded if k in live) == sorted(live)


@pytest.mark.parametrize("dtype,hd,SV,P,aligned,want", [
    (torch.bfloat16, 128, 128, 256, True, "split_tma"),     # the smoke's dense V
    (torch.bfloat16, 128, 1024, 256, True, "split_tma"),    # its V-latent
    (torch.bfloat16, 128, 416, 256, True, "split_tma"),     # the "v" serve run, padded
    (torch.bfloat16, 64, 64, 8, True, "split_tma"),
    (torch.bfloat16, 128, 409, 256, True, "tile32"),        # Rv not a multiple of 8
    (torch.bfloat16, 128, 128, 4, True, "tile32"),          # page under 8 rows
    (torch.bfloat16, 128, 128, 24, True, "tile32"),         # not a power of two
    (torch.bfloat16, 256, 256, 16, True, "tile32"),
    (torch.bfloat16, 32, 32, 16, True, "tile32"),
    (torch.bfloat16, 128, 128, 16, False, "tile32"),        # pools not 16-byte aligned
    (torch.float32, 128, 128, 256, True, "tile32"),
])
def test_kernel5_form_dispatch(dtype, hd, SV, P, aligned, want):
    assert pa._dense_form(dtype, hd, SV, P, aligned) == want
