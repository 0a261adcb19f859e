"""On-device decode in the PyTorch port, on the CPU.

The port's counterparts of the JAX package's one-dispatch decode loops
(eval/generate.py::_decode_while / generate_on_device / generate_auto and
serving/paged.py::paged_decode_scan behind the engine) replay one captured
CUDA graph per step on a card; on a CPU tensor the same step objects
(utils/graphs.py::StepGraph) run the step eagerly, which these tests drive.
They hold, with inputs and weights made from numpy seeds and handed to both
packages, in float32:

- port generate_on_device against JAX generate_on_device and port generate,
  token for token, for Llama MHA and GQA, Mistral with a sliding window and
  OPT with learned positions, over dense, latent {tk, tv} and dense K +
  latent V caches, with EOS early exit (all rows, and only some rows);
- decode_step with a 0-d tensor position against the int position: bit for
  bit, for every cache layout;
- kernel 2's plain version, and a model of its split form that launches
  every chunk (dead chunks empty, then the combine), with a device position
  against the JAX kernel in interpret mode (rtol 1e-5, atol 1e-6: f32 sums
  in another order);
- the engine through the decoder's CPU path against the JAX engine, greedy
  and sampled, stepwise and multi-step, with admission and retirement
  mid-run; the JAX and port samplers are handed the same noise table, since
  their generators differ;
- the chunk noise drawn before a scan against the noise drawn row by row.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from asvd4llm_tpu.eval import generate as jgen  # noqa: E402
from asvd4llm_tpu.models.decoder import rope_cos_sin as j_rope  # noqa: E402
from asvd4llm_tpu.ops.pallas_latent_attention import (  # noqa: E402
    _latent_attention_core as j_core,
)
from asvd4llm_tpu.serving import engine as jeng  # noqa: E402
from asvd4llm_tpu.serving import paged as jpag  # noqa: E402
from asvd4llm_tpu_torch import config as tconfig  # noqa: E402
from asvd4llm_tpu_torch import pipeline as tpipe  # noqa: E402
from asvd4llm_tpu_torch.eval import generate as tgen  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from asvd4llm_tpu_torch.ops import latent_attention as la  # noqa: E402
from asvd4llm_tpu_torch.serving import engine as teng  # noqa: E402
from asvd4llm_tpu_torch.serving import paged as tpag  # noqa: E402
from asvd4llm_tpu_torch.utils.graphs import StepGraph, counted_kernels  # noqa: E402
from test_torch_decoder import both_specs, random_tree  # noqa: E402

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=2,
            max_position_embeddings=64)
MODELS = {
    "llama_mha": ("llama_spec", dict(TINY, num_heads=4, num_kv_heads=4, head_dim=16,
                                     norm_eps=1e-5)),
    "llama_gqa": ("llama_spec", dict(TINY, num_heads=4, num_kv_heads=2, head_dim=16,
                                     norm_eps=1e-5)),
    "mistral_sliding": ("llama_spec", dict(TINY, num_heads=4, num_kv_heads=1, head_dim=16,
                                           sliding_window=5, sliding_pattern=1,
                                           norm_eps=1e-5)),
    "opt_learned": ("opt_spec", dict(TINY, num_heads=4, num_kv_heads=4, head_dim=16)),
}
# k and v low-rank in both layers, so every cache layout applies to both
LOWRANK = ((0, "k_proj"), (0, "v_proj"), (1, "k_proj"), (1, "v_proj"))
MODES = {"dense": False, "kv": True, "v": "v"}
PROMPT, NEW = (2, 6), 8


def _model(name, seed=31):
    ctor, kw = MODELS[name]
    jspec, tspec = both_specs(ctor, **kw)
    tree = random_tree(jspec, seed=seed, lowrank=LOWRANK)
    return (jspec, tspec, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tspec, dtype=torch.float32, device="cpu"))


_CACHE: dict = {}


def model(name):
    if name not in _CACHE:
        _CACHE[name] = _model(name)
    return _CACHE[name]


def _prompt(seed, shape=PROMPT):
    return np.random.RandomState(seed).randint(0, TINY["vocab_size"], shape)


# ------------------------------------------------------------ generation --

@pytest.mark.parametrize("name,mode", [
    ("llama_mha", "dense"), ("llama_mha", "kv"), ("llama_mha", "v"),
    ("llama_gqa", "dense"), ("llama_gqa", "kv"),
    ("mistral_sliding", "dense"), ("mistral_sliding", "kv"),
    ("opt_learned", "dense"), ("opt_learned", "v"),
])
def test_generate_on_device_matches_jax_and_host_loop(name, mode):
    jspec, tspec, jp, tp = model(name)
    prompt = _prompt(len(name))
    kw = dict(max_new_tokens=NEW, latent_kv=MODES[mode])
    want = jgen.generate_on_device(jp, jspec, prompt, **kw)
    got = tgen.generate_on_device(tp, tspec, prompt, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgen.generate(tp, tspec, prompt, **kw), got)
    np.testing.assert_array_equal(tgen.generate_auto(tp, tspec, prompt, **kw), got)


def test_generate_on_device_with_kernels_equals_host_loop():
    """use_pallas=True pads the ranks first (align_ranks) in both loops; the
    latent layers then run kernel 2's plain version on the CPU."""
    jspec, tspec, jp, tp = model("llama_gqa")
    prompt = _prompt(3)
    kw = dict(max_new_tokens=NEW, latent_kv=True, use_pallas=True)
    got = tgen.generate_on_device(tp, tspec, prompt, **kw)
    np.testing.assert_array_equal(got, tgen.generate(tp, tspec, prompt, **kw))
    np.testing.assert_array_equal(
        got, jgen.generate_on_device(jp, jspec, prompt, max_new_tokens=NEW,
                                     latent_kv=True))


@pytest.mark.parametrize("case", ["all_rows", "some_rows"])
def test_generate_on_device_eos_matches_jax(case, monkeypatch):
    """EOS early exit: the same tokens and n_steps as the JAX while-loop
    (tests/test_generate.py's on-device cases). all_rows: one row whose EOS
    comes at step 3 of 16, so the replays stop at the next read of the
    finished flags; some_rows: row 0's first token is EOS, row 1 keeps
    decoding to the budget and row 0's later tokens stay."""
    jspec, tspec, jp, tp = model("llama_gqa")
    monkeypatch.setattr(tgen, "READBACK_EVERY", 2)
    replays = []
    real = tgen.DecodeGraph.replay

    def spy(self, n):
        replays.append(n)
        return real(self, n)
    monkeypatch.setattr(tgen.DecodeGraph, "replay", spy)
    if case == "all_rows":
        prompt, new = _prompt(5, (1, 6)), 16
        eos = int(tgen.generate(tp, tspec, prompt, max_new_tokens=new)[0, 6 + 3])
    else:
        prompt, new = _prompt(6), 8
        eos = int(tgen.generate(tp, tspec, prompt, max_new_tokens=new)[0, 6])
    kw = dict(max_new_tokens=new, eos_token_id=eos)
    replays.clear()
    got = tgen.generate_on_device(tp, tspec, prompt, **kw)
    want = jgen.generate_on_device(jp, jspec, prompt, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgen.generate(tp, tspec, prompt, **kw), got)
    if case == "all_rows":
        assert (got[0, 6:] == eos).argmax() < 4 and got.shape[1] < 6 + new
        assert sum(replays) <= 4 + 2
    else:
        assert got.shape[1] == 6 + new and got[0, 6] == eos and sum(replays) == new - 1


def test_decode_graph_refuses_a_cache_it_would_overrun():
    """The graph never writes past the cache: a decode whose last step would
    land beyond max_len is refused before any replay."""
    _, tspec, _, tp = model("llama_mha")
    with pytest.raises(ValueError, match="cannot decode"):
        tgen.generate_on_device(tp, tspec, _prompt(1), max_new_tokens=NEW, max_len=6 + 6)
    out = tgen.generate_on_device(tp, tspec, _prompt(1), max_new_tokens=NEW,
                                  max_len=6 + NEW - 1)
    np.testing.assert_array_equal(
        out, tgen.generate(tp, tspec, _prompt(1), max_new_tokens=NEW))


@pytest.mark.parametrize("name", ["llama_gqa", "mistral_sliding", "opt_learned"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("up", [False, True])
def test_decode_step_tensor_position_is_bit_identical(name, mode, up):
    """A 0-d int32 tensor position gives the int position's logits and
    caches bit for bit (index_select / index_copy_ / a tensor mask in place
    of slices)."""
    _, tspec, _, tp = model(name)
    rng = np.random.RandomState(4)
    B, T, pos = 2, 16, 11
    caches = tgen.init_caches(tp, tspec, B, T, torch.float32, latent=MODES[mode])
    for c in caches:
        for v in c.values():
            v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.3))
    tok = torch.from_numpy(rng.randint(0, TINY["vocab_size"], (B, 1)))
    results = []
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        c = [{k: v.clone() for k, v in cache.items()} for cache in caches]
        logits, c = tgen.decode_step(tp, tspec, tok, c, p, use_pallas=up)
        results.append((logits, c))
    (l0, c0), (l1, c1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(c0, c1):
        assert all(torch.equal(a[k], b[k]) for k in a)


# --------------------------------------------------- kernel 2, device pos --

@pytest.mark.parametrize("sliding", [0, 50])
@pytest.mark.parametrize("pos", [0, 127, 128, 223])
def test_latent_attention_device_position_matches_pallas_core(pos, sliding):
    """Kernel 2's plain version and the all-chunks split model (every
    128-key chunk of T, chunks without a live key marked empty, then the
    combine) with the position as a 0-d int32 tensor, against the JAX kernel
    (interpret mode) at positions on both sides of a chunk boundary."""
    B, H, KV, hd, T, Rk, Rv = 2, 4, 2, 16, 224, 24, 16
    rng = np.random.RandomState(pos + sliding)
    q = rng.randn(B, H, hd).astype(np.float32)
    tk = (rng.randn(B, T, Rk) * 0.3).astype(np.float32)
    tv = (rng.randn(B, T, Rv) * 0.3).astype(np.float32)
    a_k = (rng.randn(KV * hd, Rk) * 0.2).astype(np.float32)
    cos, sin = (np.array(c) for c in j_rope(jnp.arange(T), hd, 10000.0))
    kw = dict(scale=hd ** -0.5, softcap=0.0, sliding=sliding, kv_heads=KV)
    ref = np.asarray(j_core(*(jnp.asarray(v) for v in (q, tk, tv, a_k, cos, sin)),
                            jnp.int32(pos), head_dim=hd, tt=32, interpret=True, **kw))
    args = [torch.from_numpy(v) for v in (q, tk, tv, a_k, cos, sin)]
    p = torch.tensor(pos, dtype=torch.int32)
    plain = la._latent_attention_core(*args, p, **kw)
    split = la.latent_attention_split_reference(*args, p, **kw)
    for out in (plain, split):
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(
        plain.numpy(), la.latent_attention_reference(*args, pos, **kw).numpy())


def test_device_position_checks():
    """An int position is checked against the cache and moved once; a
    tensor must be one int32 on the inputs' device."""
    p = la.device_position(5, 10, torch.device("cpu"))
    assert p.dtype == torch.int32 and p.shape == () and int(p) == 5
    with pytest.raises(ValueError, match="outside cache"):
        la.device_position(10, 10, torch.device("cpu"))
    with pytest.raises(ValueError, match="int32"):
        la.device_position(torch.tensor(5), 10, torch.device("cpu"))


# ---------------------------------------------------------------- engine --

RAGGED = dict(max_batch=2, page_size=8, num_pages=32, max_pages_per_seq=4)
SAMPLED = dict(temperature=0.8, top_p=0.9, seed=7919)


def _table(vocab, n_rids=4, n_pos=40, seed=17):
    """Gumbel noise [rid, sequence index, vocab], the same for both
    packages' samplers."""
    u = np.random.RandomState(seed).uniform(1e-12, 1.0, (n_rids, n_pos, vocab))
    return (-np.log(-np.log(u))).astype(np.float32)


@pytest.fixture
def shared_noise(monkeypatch):
    """Both engines draw the noise of (rid, q) from one table: the JAX
    sampler's keys and the port's generator give other numbers."""
    table = _table(TINY["vocab_size"])
    jt = jnp.asarray(table)

    def j_keyed(logits, rids, positions, seed, temperature, top_p):
        z = logits.astype(jnp.float32) / temperature
        p = jax.nn.softmax(z, axis=-1)
        order = jnp.argsort(-p, axis=-1)
        ps = jnp.take_along_axis(p, order, axis=-1)
        keep = jnp.put_along_axis(jnp.zeros(p.shape, bool), order,
                                  (jnp.cumsum(ps, axis=-1) - ps) < top_p, axis=-1,
                                  inplace=False)
        g = jt[rids.astype(jnp.int32), positions.astype(jnp.int32)]
        return jnp.argmax(jnp.where(keep, z, -jnp.inf) + g, axis=-1).astype(jnp.int32)

    monkeypatch.setattr(jpag, "sample_rows_keyed", j_keyed)
    monkeypatch.setattr(jeng, "sample_rows_keyed_jit", jax.jit(
        j_keyed, static_argnames=("seed", "temperature", "top_p")))
    monkeypatch.setattr(tpag, "_gumbel_noise",
                        lambda seed, rid, q, vocab: torch.from_numpy(table[rid, q]))


def _serve(eng, prompts, budgets, chunk=1):
    rids = [eng.add_request(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    eng.run(chunk=chunk)
    return [eng.result(r).tolist() for r in rids]


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("sampled", [False, True])
def test_engine_through_decoder_matches_jax(chunk, sampled, shared_noise):
    """Three requests through two slots ("v" pools): the third is admitted
    when the first retires; run() and run(chunk=8) through the decoder's CPU
    path emit the JAX engine's tokens, greedy and sampled."""
    jspec, tspec, jp, tp = model("llama_gqa")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, TINY["vocab_size"], (n,)) for n in (5, 13, 9)]
    budgets = [8, 5, 7]
    kw = dict(latent="v", use_pallas=False, **RAGGED, **(SAMPLED if sampled else {}))
    want = _serve(jeng.PagedEngine(jp, jspec, **kw), prompts, budgets, chunk=1)
    eng = teng.PagedEngine(tp, tspec, **kw)
    got = _serve(eng, prompts, budgets, chunk=chunk)
    assert got == want and [len(t) for t in got] == budgets
    assert list(eng._decoder.graphs) == [chunk]
    graph = eng._decoder.graphs[chunk][0]
    assert graph.graph is None and not graph.per_replay   # eager on the CPU
    if sampled:
        assert eng._decoder.graphs[chunk][2].shape == (chunk, 2, TINY["vocab_size"])


def test_chunk_noise_equals_row_by_row_noise():
    rids, positions, n, V = [3, 0, 7], [10, 0, 5], 4, 64
    noise = tpag.chunk_noise(11, rids, positions, n, V)
    assert noise.shape == (n, 3, V) and noise.dtype == torch.float32
    for s in range(n):
        for b, (r, p) in enumerate(zip(rids, positions)):
            assert torch.equal(noise[s, b], tpag._gumbel_noise(11, r, p + s + 1, V))


def test_sampled_scan_equals_stepwise_row_by_row_sampling():
    """paged_decode_scan with its noise drawn before the steps emits what
    paged_decode_step followed by sample_rows_keyed (noise drawn row by row
    at each step) emits."""
    _, tspec, _, tp = model("llama_mha")
    P, MP, NP = 8, 4, 12
    pools = tpag.init_paged_pools(tp, tspec, NP, P, torch.float32, latent="kv")
    rng = np.random.RandomState(9)
    for pool in pools:
        for v in pool.values():
            v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.3))
    pt = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0]], dtype=torch.int32)
    positions = torch.tensor([13, 4], dtype=torch.int32)
    token = torch.tensor([[7], [100]])
    rids, n = [2, 5], 5
    kw = dict(temperature=0.8, top_p=0.9, seed=3)
    clone = [{k: v.clone() for k, v in p.items()} for p in pools]
    got, _ = tpag.paged_decode_scan(tp, tspec, token, clone, pt, positions, n,
                                    rids=rids, **kw)
    tok, pos, want = token, positions, []
    for step in range(n):
        logits, pools = tpag.paged_decode_step(tp, tspec, tok, pools, pt, pos)
        nxt = tpag.sample_rows_keyed(logits, rids, (positions + step + 1).tolist(),
                                     kw["seed"], kw["temperature"], kw["top_p"])
        want.append(nxt)
        tok, pos = nxt[:, None].long(), pos + 1
    assert torch.equal(got, torch.stack(want, dim=1).long())


# ------------------------------------------------------------------ misc --

def test_step_graph_runs_eagerly_on_the_cpu():
    """On CPU tensors a StepGraph calls the step on each replay and counts
    no launch."""
    state = torch.zeros((), dtype=torch.int64)

    def step():
        state.add_(1)
    before = {k: fn.launches for k, fn in counted_kernels().items()}
    g = StepGraph(step, [state])
    g.replay(3)
    assert int(state) == 3 and g.graph is None and g.capture_s == 0.0
    assert {k: fn.launches for k, fn in counted_kernels().items()} == before


def test_mesh_shape_names_the_multi_gpu_item():
    """A mesh above one device raises with the ROADMAP item that ports it
    (queue 1 item 7, multi-GPU)."""
    cfg = tconfig.ASVDConfig(model_id="m", mesh_shape=(2, 1))
    with pytest.raises(NotImplementedError,
                       match=r"mesh_shape=\(2, 1\) is still to port \(ROADMAP queue 1, item 7\)"):
        tpipe.check_supported(cfg)
