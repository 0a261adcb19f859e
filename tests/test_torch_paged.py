"""PyTorch port vs JAX package: the paged serving path, in float32 on the
CPU — kernels 5 and 6 (plain versions) against the JAX wrappers, the paged
decode step, the batched append and the page prefill in all three pool
modes, the continuous-batching engine token for token, the layout selector,
the automatic page size and sampling.

The JAX paged kernels run in interpret mode: their cores are patched for
this module before the first use_pallas=True trace, as the JAX package's
own test does. The port's kernels take their plain versions on CPU tensors.
Inputs and weights are made with numpy from seeds and handed to both
packages (params_from_numpy, pools_from_numpy).
Tolerance: attention outputs and logits atol/rtol 1e-4 (true-f32 sums on
both sides, in another order); pools 1e-5 (one projection each); tokens
exact.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import asvd4llm_tpu.ops.pallas_latent_attention as pla  # noqa: E402
from asvd4llm_tpu.ops import quant_apply as jqa  # noqa: E402
from asvd4llm_tpu.ops.pallas_lowrank import prepad_quantized_leaves  # noqa: E402
from asvd4llm_tpu.serving import engine as jeng  # noqa: E402
from asvd4llm_tpu.serving import layout as jlay  # noqa: E402
from asvd4llm_tpu.serving import paged as jpag  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy, pools_from_numpy  # noqa: E402
from asvd4llm_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from asvd4llm_tpu_torch.serving import engine as teng  # noqa: E402
from asvd4llm_tpu_torch.serving import layout as tlay  # noqa: E402
from asvd4llm_tpu_torch.serving import paged as tpag  # noqa: E402
from test_torch_decoder import BASE, both_specs, random_tree  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
POOL_TOL = dict(atol=1e-5, rtol=1e-5)
MODES = [False, "v", "kv"]
# both layers' k and v low-rank (all three pool modes apply), plus a
# low-rank q and down projection for the fused linear's plain version
LOWRANK = ((0, "k_proj"), (0, "v_proj"), (1, "k_proj"), (1, "v_proj"),
           (0, "q_proj"), (1, "down_proj"))
P, NP, MP = 8, 16, 4


@pytest.fixture(scope="module", autouse=True)
def jax_paged_kernels_interpret():
    """The JAX paged kernels in interpret mode for every trace of this
    module."""
    def interpreted(orig, *a, **kw):
        return orig(*a, **dict(kw, interpret=True))

    mp = pytest.MonkeyPatch()
    for name in ("_paged_dense_core", "_paged_latent_core"):
        mp.setattr(pla, name, functools.partial(interpreted, getattr(pla, name)))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def model():
    jspec, tspec = both_specs("llama_spec", **dict(
        BASE, hidden_size=64, intermediate_size=96, num_heads=4, num_kv_heads=2,
        head_dim=16, norm_eps=1e-5))
    tree = random_tree(jspec, seed=21, lowrank=LOWRANK)
    return jspec, tspec, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, tspec)


def _n(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_pools(tpools, jpools, **tol):
    """Pools equal outside the scratch page 0 (which takes the colliding,
    ignored writes of padded rows)."""
    for tp, jp in zip(tpools, jpools):
        assert set(tp) == set(jp)
        for k in tp:
            np.testing.assert_allclose(_n(tp[k])[1:], _n(jp[k])[1:], err_msg=k, **tol)


# ------------------------------------------------- kernels 5 and 6, plain --

KERNEL_CASES = {
    # name: (kernel, KV, rep, page, softcap, sliding, v bias)
    "dense_mha_bias": ("dense", 4, 1, 8, 0.0, 0, True),
    "dense_gqa_sliding": ("dense", 2, 2, 16, 0.0, 10, False),
    "vlatent_gqa_softcap_bias": ("vlatent", 2, 2, 8, 5.0, 0, True),
    "vlatent_mha_sliding": ("vlatent", 4, 1, 16, 0.0, 7, False),
    "latent_mha": ("latent", 4, 1, 16, 0.0, 0, False),
    "latent_gqa_softcap_sliding_bias": ("latent", 2, 2, 8, 5.0, 9, True),
}


def _paged_inputs(rng, page, KV, rep, hd=16, mp=4, rk=12, rv=10):
    """Shuffled pages, ragged positions: a row in its 3rd page (partial),
    a scratch-page slot (table all 0, position 0), a row at the last slot
    of its first page, a full row, and a row at position 0 on a real
    page."""
    B = 5
    n_pages = 1 + B * mp
    perm = rng.permutation(n_pages - 1) + 1
    pt = perm.reshape(B, mp).astype(np.int32)
    pt[1] = 0
    positions = np.asarray([2 * page + 3, 0, page - 1, mp * page - 1, 0], np.int32)
    H = KV * rep
    f = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)  # noqa: E731
    return dict(B=B, H=H, q=f(B, H, hd), pt=pt, positions=positions,
                k_pool=f(n_pages, page, KV, hd), v_pool=f(n_pages, page, KV, hd),
                tv_pool=f(n_pages, page, rv), tk_pool=f(n_pages, page, rk),
                a_k=f(KV * hd, rk) * rk ** -0.5, a_v=f(KV * hd, rv) * rv ** -0.5,
                v_bias=f(KV * hd), cos=np.cos(f(mp * page, hd)),
                sin=np.sin(f(mp * page, hd)))


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_paged_kernel_plain_matches_jax(case):
    kind, KV, rep, page, cap, sw, bias = KERNEL_CASES[case]
    d = _paged_inputs(np.random.RandomState(len(case)), page, KV, rep)
    J, T = jnp.asarray, torch.from_numpy
    kw = dict(kv_heads=KV, scale=16 ** -0.5, softcap=cap, sliding=sw)
    vb = d["v_bias"] if bias else None
    n5 = tpa.paged_dense_decode_attention.launches
    n6 = tpa.paged_latent_decode_attention.launches
    if kind == "latent":
        args = [d[k] for k in ("q", "tk_pool", "tv_pool", "a_k", "a_v", "cos", "sin",
                               "pt", "positions")]
        ref = pla.paged_latent_decode_attention(*map(J, args), **kw,
                                                v_bias=None if vb is None else J(vb))
        out = tpa.paged_latent_decode_attention(*map(T, args), **kw,
                                                v_bias=None if vb is None else T(vb))
    else:
        v = d["v_pool"] if kind == "dense" else d["tv_pool"]
        a_v = None if kind == "dense" else d["a_v"]
        args = [d["q"], d["k_pool"], v, d["pt"], d["positions"]]
        ref = pla.paged_dense_decode_attention(
            *map(J, args), **kw, a_v=None if a_v is None else J(a_v),
            v_bias=None if vb is None else J(vb))
        out = tpa.paged_dense_decode_attention(
            *map(T, args), **kw, a_v=None if a_v is None else T(a_v),
            v_bias=None if vb is None else T(vb))
    assert out.shape == (d["B"], d["H"] * 16) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())      # the scratch slot included
    np.testing.assert_allclose(_n(out), _n(ref), **TOL)
    # a CPU tensor takes the plain version: no launch counted
    assert (tpa.paged_dense_decode_attention.launches,
            tpa.paged_latent_decode_attention.launches) == (n5, n6)


# ----------------------------------- prefill, decode step, batched append --

@pytest.fixture(scope="module")
def prefilled(model):
    """Per pool mode: three prompts (5, 13 and 9 tokens) prefilled by each
    package into the same shuffled pages; row 3 is an idle slot."""
    jspec, tspec, jp, tp = model
    rng = np.random.RandomState(5)
    lengths = (5, 13, 9)
    prompts = [rng.randint(0, 96, (1, n)) for n in lengths]
    pt = np.zeros((4, MP), np.int32)
    pt[:3] = (rng.permutation(NP - 1)[:3 * MP] + 1).reshape(3, MP)
    out = {}
    for mode in MODES:
        jpools = jpag.init_paged_pools(jp, jspec, NP, P, jnp.float32, latent=mode)
        tpools = tpag.init_paged_pools(tp, tspec, NP, P, torch.float32, latent=mode)
        jlog, tlog = [], []
        for b, ids in enumerate(prompts):
            lj, jpools = jpag.prefill_into_pages(jp, jspec, jnp.asarray(ids), jpools,
                                                 list(pt[b]))
            lt, tpools = tpag.prefill_into_pages(tp, tspec, torch.from_numpy(ids),
                                                 tpools, list(pt[b]))
            jlog.append(_n(lj))
            tlog.append(_n(lt))
        out[mode] = dict(jpools=jpools, tpools=tpools, jlog=jlog, tlog=tlog,
                         pt=pt, positions=np.asarray(lengths + (0,), np.int32))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_prefill_into_pages_matches_jax(prefilled, mode):
    st = prefilled[mode]
    for lt, lj in zip(st["tlog"], st["jlog"]):
        np.testing.assert_allclose(lt, lj, **TOL)
    _assert_pools(st["tpools"], st["jpools"], **POOL_TOL)


@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_paged_decode_step_matches_jax(model, prefilled, mode, up):
    jspec, tspec, jp, tp = model
    st = prefilled[mode]
    jpools = [dict(p) for p in st["jpools"]]
    tpools = pools_from_numpy([{k: np.asarray(v) for k, v in p.items()}
                               for p in st["jpools"]])
    tok = np.asarray([[3], [17], [42], [0]])
    ref, jpools = jpag.paged_decode_step(jp, jspec, jnp.asarray(tok), jpools,
                                         jnp.asarray(st["pt"]),
                                         jnp.asarray(st["positions"]), use_pallas=up)
    out, tpools = tpag.paged_decode_step(tp, tspec, torch.from_numpy(tok), tpools,
                                         torch.from_numpy(st["pt"]),
                                         torch.from_numpy(st["positions"]),
                                         use_pallas=up)
    np.testing.assert_allclose(_n(out), _n(ref), **TOL)
    _assert_pools(tpools, jpools, **POOL_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_append_batch_select_matches_jax(model, prefilled, mode):
    """A 4-token segment appended after each prompt (the idle row padded),
    with the head on gathered (row, column) pairs."""
    jspec, tspec, jp, tp = model
    st = prefilled[mode]
    jpools = [dict(p) for p in st["jpools"]]
    tpools = pools_from_numpy([{k: np.asarray(v) for k, v in p.items()}
                               for p in st["jpools"]])
    ids = np.random.RandomState(8).randint(0, 96, (4, 4))
    rows = np.asarray([0, 2, 1, 0])
    cols = np.asarray([3, 1, 0, 0])
    args = (ids, st["pt"], st["positions"], rows, cols)
    ref, jpools = jpag.paged_append_batch_select(jp, jspec, jnp.asarray(ids), jpools,
                                                 *map(jnp.asarray, args[1:]))
    out, tpools = tpag.paged_append_batch_select(tp, tspec, torch.from_numpy(ids), tpools,
                                                 *map(torch.from_numpy, args[1:]))
    np.testing.assert_allclose(_n(out), _n(ref), **TOL)
    _assert_pools(tpools, jpools, **POOL_TOL)


# -------------------------------------------------------------- engine --

def _engines(model, **kw):
    jspec, tspec, jp, tp = model
    return (jeng.PagedEngine(jp, jspec, **kw), teng.PagedEngine(tp, tspec, **kw))


def _serve(eng, prompts, budgets, chunk=1):
    rids = [eng.add_request(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    eng.run(chunk=chunk)
    return [eng.result(r).tolist() for r in rids]


RAGGED = dict(max_batch=2, page_size=P, num_pages=32, max_pages_per_seq=4)


@pytest.fixture(scope="module")
def ragged_prompts():
    rng = np.random.RandomState(1)
    return [rng.randint(0, 96, (n,)) for n in (5, 13, 9)], [8, 5, 7]


@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_engine_ragged_batching_matches_jax(model, ragged_prompts, mode, up):
    """Three prompts through two slots: ragged positions, admission from
    the waiting queue and retirement mid-run, token for token."""
    jeng_, teng_ = _engines(model, latent=mode, use_pallas=up, **RAGGED)
    prompts, budgets = ragged_prompts
    want = _serve(jeng_, prompts, budgets)
    got = _serve(teng_, prompts, budgets)
    assert got == want
    assert [len(t) for t in got] == budgets


def test_engine_page_reuse_matches_jax(model, ragged_prompts):
    """One slot and 4 usable pages: the second request reuses the first's
    pages after it retires."""
    jeng_, teng_ = _engines(model, latent=False, max_batch=1, page_size=P,
                            num_pages=5, max_pages_per_seq=4)
    prompts = ragged_prompts[0][::2]
    free0 = len(teng_.free_pages)
    want = _serve(jeng_, prompts, [6, 6])
    got = _serve(teng_, prompts, [6, 6])
    assert got == want
    assert len(teng_.free_pages) == free0 and not teng_.page_refs


@pytest.mark.parametrize("mode", ["v", "kv"])
def test_engine_run_chunked_matches_stepwise(model, ragged_prompts, mode):
    """run(chunk=4), with a request ending mid-chunk, equals stepwise
    decoding and the JAX engine's tokens."""
    prompts, budgets = ragged_prompts
    jeng_, teng_ = _engines(model, latent=mode, use_pallas=True, **RAGGED)
    want = _serve(jeng_, prompts, budgets)
    got = _serve(teng_, prompts, budgets, chunk=4)
    assert got == want
    _, t1 = _engines(model, latent=mode, use_pallas=True, **RAGGED)
    assert _serve(t1, prompts, budgets) == got


def test_engine_prefix_cache_matches_jax(model):
    """Chunked prefill with the prefix cache: the same tokens and the same
    prefill tokens skipped as the JAX engine; page accounting balances."""
    rng = np.random.RandomState(11)
    sys_prompt = rng.randint(0, 96, (3 * P,))
    p1 = np.concatenate([sys_prompt, rng.randint(0, 96, (5,))])
    p2 = np.concatenate([sys_prompt, rng.randint(0, 96, (7,))])
    jeng_, teng_ = _engines(model, latent="kv", use_pallas=True, max_batch=1,
                            page_size=P, num_pages=32, max_pages_per_seq=5,
                            prefill_chunk=P, prefix_cache=8)
    outs, filled = [], []
    for eng in (jeng_, teng_):
        o, f = [], []
        for p in (p1, p2, p1):
            rid = eng.add_request(p, max_new_tokens=4)
            f.append(eng.requests[rid].filled)
            eng.run(chunk=2)
            o.append(eng.result(rid).tolist())
        outs.append(o)
        filled.append(f)
    assert outs[1] == outs[0]
    assert filled[1] == filled[0] == [0, 3 * P, 3 * P]
    assert teng_.stats()["prefix_tokens_skipped"] == 6 * P
    held = {p for pages, _ in teng_._prefix_index.values() for p in pages}
    assert held.isdisjoint(teng_.free_pages)
    teng_.clear_prefix_cache()
    assert sorted(teng_.free_pages) == list(range(1, 32)) and not teng_.page_refs


@pytest.mark.parametrize("mode", ["v", "kv"])
def test_engine_whole_prompt_prefill_with_dense_first_layer(model, ragged_prompts, mode):
    """A model whose layer 0 keeps a dense cache in a latent mode (only
    layer 1's k and v are low-rank): whole-prompt admission fills every
    layer's pages and emits the chunked admission's tokens, which equal
    the JAX engine's (the JAX package's whole-prompt admission reads the
    mode from layer 0 and fails on such a model)."""
    jspec, tspec, jp, tp = model
    tree = random_tree(jspec, seed=21, lowrank=((1, "k_proj"), (1, "v_proj")))
    jp2, tp2 = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, tspec)
    prompts, budgets = ragged_prompts
    kw = dict(latent=mode, use_pallas=True, **RAGGED)
    want = _serve(jeng.PagedEngine(jp2, jspec, prefill_chunk=4, **kw), prompts, budgets)
    eng = teng.PagedEngine(tp2, tspec, **kw)
    assert "k" in eng.pools[0] and "v" in eng.pools[0] and "tv" in eng.pools[1]
    assert _serve(eng, prompts, budgets) == want
    assert _serve(teng.PagedEngine(tp2, tspec, prefill_chunk=4, **kw), prompts,
                  budgets) == want


def test_engine_eos_retirement_matches_jax(model, ragged_prompts):
    """EOS retires a request early (its tokens end at EOS) while the other
    slot keeps decoding."""
    prompts = ragged_prompts[0][:2]
    _, probe = _engines(model, latent=False, **RAGGED)
    eos = _serve(probe, prompts[:1], [1])[0][0]
    jeng_, teng_ = _engines(model, latent=False, eos_token_id=eos, **RAGGED)
    want = _serve(jeng_, prompts, [10, 6])
    got = _serve(teng_, prompts, [10, 6])
    assert got == want and got[0] == [eos]


@pytest.mark.parametrize("up", [False, True])
def test_engine_int8_deployed_matches_jax(model, ragged_prompts, up):
    """An int8-deployed model: the JAX engine pre-pads its codes itself; the
    port is handed the pre-padded params and pads nothing."""
    jspec, tspec, jp, _ = model
    jq = jqa.quantize_lowrank_factors_int8(jp, jspec)
    tq = params_from_numpy(jax.tree.map(np.asarray, prepad_quantized_leaves(jq, jspec)))
    kw = dict(latent="kv", use_pallas=up, **RAGGED)
    prompts, budgets = ragged_prompts
    want = _serve(jeng.PagedEngine(jq, jspec, **kw), prompts, budgets)
    got = _serve(teng.PagedEngine(tq, tspec, **kw), prompts, budgets)
    assert got == want


def test_engine_stats_and_stream(model, ragged_prompts):
    prompts, budgets = ragged_prompts
    _, eng = _engines(model, latent="v", **RAGGED)
    rids = [eng.add_request(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    got = {r: [] for r in rids}
    for rid, tok in eng.stream(chunk=3):
        got[rid].append(tok)
    assert [got[r] for r in rids] == [eng.result(r).tolist() for r in rids]
    agg = eng.stats()
    assert agg["requests_done"] == 3 and agg["tokens_generated"] == sum(budgets)
    assert agg["ttft_s"]["p50"] is not None and agg["tpot_s"]["p90"] is not None
    st = eng.request_stats(rids[0])
    assert st["done"] and st["n_tokens"] == budgets[0] and st["ttft_s"] >= 0


def test_auto_page_size_keeps_pool_bytes(model):
    """An automatic page size keeps the pool at num_pages x 64 tokens: the
    same pool bytes as page_size=64 (the JAX engine pairs its large
    automatic page with the unchanged num_pages)."""
    _, tspec, _, tp = model
    auto = teng.PagedEngine(tp, tspec, latent=False)
    fixed = teng.PagedEngine(tp, tspec, latent=False, page_size=64)
    nbytes = lambda e: sum(t.numel() * t.element_size()  # noqa: E731
                           for p in e.pools for t in p.values())
    assert auto.page_size == tpag.default_page_size(2, 16, 4) > 64
    assert nbytes(auto) == nbytes(fixed) and fixed.pools[0]["k"].shape[0] == 128
    assert teng.PagedEngine(tp, tspec, latent=False, page_size=32).pools[0]["k"].shape[0] == 128


# -------------------------------------------------------------- layout --

def _layout_params(kv_dim, rk, rv, n_layers=2):
    """(JAX-side, port-side) params with only the shapes the selector
    reads."""
    def leaf(r):
        if r is None:
            return {"w": np.zeros((kv_dim, 8), np.float32), "b": None}
        return {"A": np.zeros((kv_dim, r), np.float32),
                "B": np.zeros((r, 8), np.float32), "b": None}
    tree = {"layers": [{"k_proj": leaf(rk), "v_proj": leaf(rv)}
                       for _ in range(n_layers)],
            "embed_tokens": np.zeros((4, 8), np.float32)}
    return tree, params_from_numpy(tree)


LAYOUT_CASES = {
    # name: (heads, kv heads, rk, rv, prefer_memory, expected_T)
    "mha_long": (4, 4, None, 20, False, 4096),
    "mha_short": (4, 4, None, 20, False, 1024),
    "gqa_strong": (8, 2, None, 12, False, 8192),
    "gqa_thin_short": (8, 2, None, 24, False, 1024),
    "gqa_thin_long": (8, 2, None, 24, False, 4096),
    "prefer_memory": (4, 4, 16, 20, True, None),
    "no_saving": (4, 4, None, None, False, 4096),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_choose_layout_matches_jax(case):
    heads, kv, rk, rv, prefer, exp_t = LAYOUT_CASES[case]
    jspec, tspec = both_specs("llama_spec", **dict(
        BASE, hidden_size=8 * heads, num_heads=heads, num_kv_heads=kv, head_dim=8))
    jtree, tparams = _layout_params(kv * 8, rk, rv)
    for backend, device in (("cpu", "cpu"), ("tpu", "cuda")):
        ref = jlay.choose_layout(jtree, jspec, backend=backend,
                                 prefer_memory=prefer, expected_T=exp_t)
        got = tlay.choose_layout(tparams, tspec, device=device,
                                 prefer_memory=prefer, expected_T=exp_t)
        assert (got.latent, got.use_pallas) == (ref.latent, ref.use_pallas), backend
        assert got.cache_ratio == pytest.approx(ref.cache_ratio, rel=1e-12)


# ------------------------------------------------------------ sampling --

def test_sampling_stepwise_equals_multistep(model, ragged_prompts):
    """Position-keyed sampling: run(chunk=4) emits the stepwise tokens, the
    same seed repeats, another seed differs."""
    prompts, budgets = ragged_prompts

    def serve(seed, chunk):
        _, eng = _engines(model, latent="v", temperature=1.3, top_p=0.9, seed=seed,
                          prefill_chunk=4, **RAGGED)
        return _serve(eng, prompts, budgets, chunk=chunk)

    assert serve(3, 4) == serve(3, 1) == serve(3, 4)
    assert any(serve(s, 1) != serve(3, 1) for s in (4, 5))


def test_top_p_keep_mask_matches_jax():
    """The keep mask of the JAX sampler (serving/paged.py:_sample_rows,
    top-p cut over the exclusive cumulative mass) on the same logits."""
    logits = np.random.RandomState(2).randn(6, 96).astype(np.float32) * 2
    for temperature, top_p in ((1.0, 0.9), (0.7, 0.5), (1.5, 1.0)):
        z = jnp.asarray(logits) / temperature
        p = jax.nn.softmax(z, axis=-1)
        order = jnp.argsort(-p, axis=-1)
        ps = jnp.take_along_axis(p, order, axis=-1)
        keep_sorted = (jnp.cumsum(ps, axis=-1) - ps) < top_p
        want = jnp.put_along_axis(jnp.zeros_like(keep_sorted), order, keep_sorted,
                                  axis=-1, inplace=False)
        got = tpag._top_p_keep(torch.from_numpy(logits) / temperature, top_p)
        np.testing.assert_array_equal(_n(got), _n(want))


def test_sample_rows_matches_jax_with_same_noise():
    """With the Gumbel noise the JAX sampler draws from its keys handed to
    the port, the sampled tokens are the JAX sampler's."""
    logits = np.random.RandomState(4).randn(5, 96).astype(np.float32) * 3
    keys = jax.vmap(lambda r: jax.random.fold_in(jax.random.PRNGKey(7), r))(
        jnp.arange(5, dtype=jnp.uint32))
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (96,)))(keys))
    for temperature, top_p in ((1.0, 0.9), (0.6, 0.6)):
        want = jpag._sample_rows(jnp.asarray(logits), keys, temperature, top_p)
        got = tpag._sample_rows(torch.from_numpy(logits), torch.from_numpy(noise),
                                temperature, top_p)
        np.testing.assert_array_equal(_n(got), _n(want))
