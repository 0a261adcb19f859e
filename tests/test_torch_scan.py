"""PyTorch port vs JAX package: the prefix-cached sensitivity scan, its
per-leaf resume files, its device-OOM ladder and the search's factor
checkpoints, on tiny float32 models on the CPU.

The JAX side runs ``calib_sensitivity_ppl(..., batch_ratios=True)``, which
takes ``_scan_suffix_sensitivity`` on these uniform dense models. Both
packages get the same numpy weights, calibration rows and act-aware
statistics, with the exact SVD. Tolerances: sensitivity PPLs rtol 1e-3
against JAX and rtol 1e-5 against the port's serial loop; manifests, dict
order and resumed dicts exactly equal; reloaded factors bit for bit.
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from asvd4llm_tpu import config as jconfig  # noqa: E402
from asvd4llm_tpu.calib import search as jsearch  # noqa: E402
from asvd4llm_tpu.calib import sensitivity as jsens  # noqa: E402
from asvd4llm_tpu.models import registry as jregistry  # noqa: E402
from asvd4llm_tpu_torch import config as tconfig  # noqa: E402
from asvd4llm_tpu_torch import pipeline as tpipe  # noqa: E402
from asvd4llm_tpu_torch.calib import search as tsearch  # noqa: E402
from asvd4llm_tpu_torch.calib import sensitivity as tsens  # noqa: E402
from asvd4llm_tpu_torch.models import scan_forward as tscan  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from asvd4llm_tpu_torch.models.registry import (  # noqa: E402
    get_linear, iter_linears, lowrank_leaf, q4_lowrank_leaf, q8_lowrank_leaf,
)
from asvd4llm_tpu_torch.ops import svd as tsvd  # noqa: E402
from test_torch_decoder import BASE, both_specs, random_tree  # noqa: E402

SEQLEN = 16
FAMILIES = {
    "llama": ("llama_spec", dict(BASE, num_heads=4, num_kv_heads=2, head_dim=8,
                                 norm_eps=1e-5), 0),
    # sliding window 6 < the 15 input positions: layers alternate masks
    "gemma2": ("gemma2_spec", dict(BASE, num_heads=4, num_kv_heads=2, head_dim=8,
                                   embed_scale=32 ** 0.5, attn_scale=8 ** -0.5,
                                   attn_logit_softcap=5.0, final_logit_softcap=3.0,
                                   sliding_window=6), 0),
    # OPT-350m's project_in/out: the extras' serial branch
    "opt_project": ("opt_spec", dict(BASE, num_heads=4, num_kv_heads=4, head_dim=8,
                                     word_embed_proj_dim=16), 16),
}


def _model(family, seed=31, square=False):
    """Numpy weights, calibration rows and statistics for both packages.
    ``square``: every decoder linear 32 x 32 (MHA, intermediate 32), which
    spares the JAX side a compile per leaf shape."""
    ctor, kw, proj = FAMILIES[family]
    if square:
        kw = dict(kw, num_kv_heads=4, intermediate_size=32)
    jspec, tspec = both_specs(ctor, **kw)
    tree = random_tree(jspec, seed=seed, proj_dim=proj)
    rng = np.random.RandomState(seed + 1)
    loader = [{"input_ids": rng.randint(0, kw["vocab_size"], (1, SEQLEN))}
              for _ in range(3)]
    stats = {n: (np.abs(rng.randn(leaf["w"].shape[1])) + 0.2).astype(np.float32)
             for n, leaf in iter_linears(params_from_numpy(tree, tspec), tspec,
                                         include_extras=True)}
    return jspec, tspec, tree, loader, stats


def _cfgs(**kw):
    kw = dict(dict(alpha=0.5, rank_align=2, n_calib_samples=3, seqlen=SEQLEN,
                   svd_backend="exact", act_aware=True, use_cache=False), **kw)
    return jconfig.ASVDConfig(**kw), tconfig.ASVDConfig(**kw)


def _port(tree, tspec):
    return params_from_numpy(tree, tspec)


def _tstats(stats):
    return {k: torch.from_numpy(v) for k, v in stats.items()}


def _jstats(stats):
    return {k: jnp.asarray(v) for k, v in stats.items()}


def _assert_same_dict(out, ref, rtol):
    assert list(out) == list(ref)
    for name in ref:
        assert list(out[name]) == list(ref[name]), name
        np.testing.assert_allclose(list(out[name].values()),
                                   list(ref[name].values()), rtol=rtol,
                                   err_msg=name)


def _search_both(jspec, tspec, tree, loader, stats, jsd, tsd, kw):
    jcfg, tcfg = _cfgs(**kw)
    _, jman = jsearch.binary_search_truncation_rank(
        jax.tree.map(jnp.asarray, tree), jspec, jsd, loader, jcfg,
        stats=_jstats(stats))
    _, tman = tsearch.binary_search_truncation_rank(
        _port(tree, tspec), tspec, tsd, loader, tcfg, stats=_tstats(stats))
    return jman, tman


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("grid", ["weight", "kv"])
def test_suffix_scan_matches_jax_and_manifests_equal(family, grid):
    """The port's suffix scan against JAX's ``_scan_suffix_sensitivity``,
    then both searches on their own package's dict: identical manifests
    for the parameter and PPL targets (weight grid) or the KV target. Square
    decoder linears; the tall and wide ones run in the tests below."""
    jspec, tspec, tree, loader, stats = _model(family, square=True)
    kv = grid == "kv"
    jcfg, tcfg = _cfgs(compress_kv_cache=kv)
    assert jsens.jax.default_backend() == "cpu"
    ref = jsens.calib_sensitivity_ppl(jax.tree.map(jnp.asarray, tree), jspec, loader,
                                      jcfg, stats=_jstats(stats), batch_ratios=True)
    tparams = _port(tree, tspec)
    assert tscan.can_scan(tparams, tspec)
    out = tsens.calib_sensitivity_ppl(tparams, tspec, loader, tcfg,
                                      stats=_tstats(stats))
    _assert_same_dict(out, ref, rtol=1e-3)
    if kv:
        targets = [dict(compress_kv_cache=True, kv_cache_ratio_target=0.55)]
    else:
        ppls = sorted(p for d in ref.values() for p in d.values() if np.isfinite(p))
        targets = [dict(param_ratio_target=0.8),
                   dict(ppl_target=float(ppls[len(ppls) // 2]))]
    for kw in targets:
        jman, tman = _search_both(jspec, tspec, tree, loader, stats, ref, out, kw)
        assert tman and tman == jman and list(tman) == list(jman), kw


@pytest.mark.parametrize("family,backend", [("llama", "exact"), ("gemma2", "exact"),
                                            ("llama", "randomized")])
def test_suffix_scan_matches_serial_scan(family, backend):
    """The two evaluators of the port agree; with the randomized SVD both
    draw each leaf's generator the same way."""
    _, tspec, tree, loader, stats = _model(family)
    _, tcfg = _cfgs(svd_backend=backend)
    tparams = _port(tree, tspec)
    log = []
    suffix = tsens.calib_sensitivity_ppl(tparams, tspec, loader, tcfg,
                                         stats=_tstats(stats), scan_log=log)
    serial = tsens.calib_sensitivity_ppl(
        tparams, tspec, loader, tcfg.replace(sensitivity_batch_ratios=False),
        stats=_tstats(stats))
    _assert_same_dict(suffix, serial, rtol=1e-5)
    assert len(log) == len(suffix)
    assert {r["backend"] for r in log} == {backend}


def test_can_scan_refuses_factored_leaves():
    """An int4 leaf makes ``can_scan`` False (the JAX version tests only
    int8 leaves, :48, :52), as do int8 and low-rank leaves."""
    _, tspec, tree, _, _ = _model("llama")
    tparams = _port(tree, tspec)
    assert tscan.can_scan(tparams, tspec)
    r = 4
    leaves = {
        "lowrank": lowrank_leaf(torch.zeros(32, r), torch.zeros(r, 32)),
        "q8": q8_lowrank_leaf(*(torch.zeros(1),) * 6),
        "q4": q4_lowrank_leaf(*(torch.zeros(1),) * 6),
    }
    for kind, leaf in leaves.items():
        params = dict(tparams, layers=[dict(tparams["layers"][0]),
                                       tparams["layers"][1]])
        params["layers"][0]["q_proj"] = leaf
        assert not tscan.can_scan(params, tspec), kind


def test_scan_forward_from_start_matches_full_forward():
    """Running layers l..L-1 from the dense hidden at layer l's input gives
    the full forward's hidden (Gemma-2: masks chosen per layer)."""
    from asvd4llm_tpu_torch.models.decoder import forward_hidden
    _, tspec, tree, loader, _ = _model("gemma2")
    p = _port(tree, tspec)
    ids = torch.as_tensor(loader[0]["input_ids"])
    full, _ = forward_hidden(p, ids, tspec)
    h, _, _ = tscan.embed_scan_inputs(p, ids, tspec)
    for start in range(len(p["layers"]) + 1):
        np.testing.assert_allclose(
            tscan.forward_hidden_scan_from(p, h, tspec, start=start).numpy(),
            full.numpy(), rtol=1e-5, atol=1e-5)
        if start < len(p["layers"]):
            h = tscan.apply_stacked_layer(p, h, tspec, idx=start)


# ------------------------------------------------------------- resume ---

def _scan(tree, tspec, loader, stats, tcfg, resume, log=None):
    return tsens.calib_sensitivity_ppl(_port(tree, tspec), tspec, loader, tcfg,
                                       stats=_tstats(stats), resume=resume,
                                       scan_log=log)


def test_resume_replays_half_a_scan_with_the_rng_stream(tmp_path):
    """A scan cut after half its leaves, resumed from its JSONL (the torn
    last line ignored), recomputes only the missing leaves and gives the
    same dict bit for bit, with the randomized SVD's per-leaf draws."""
    _, tspec, tree, loader, stats = _model("llama")
    _, tcfg = _cfgs(svd_backend="randomized")
    path = str(tmp_path / "scan.jsonl")
    full = _scan(tree, tspec, loader, stats, tcfg, path)
    with open(path) as f:
        lines = f.readlines()
    assert [json.loads(ln)["name"] for ln in lines] == list(full)
    keep = len(lines) // 2
    with open(path, "w") as f:
        f.writelines(lines[:keep])
        f.write(lines[keep][:20])           # a torn line from a killed process
    log = []
    again = _scan(tree, tspec, loader, stats, tcfg, path, log)
    assert again == full and list(again) == list(full)
    assert [r["name"] for r in log] == list(full)[keep:]


def test_resume_files_read_both_ways(tmp_path):
    """A JSONL written by the JAX package's writer is replayed by the port's
    scan, and the port's by JAX's scan (every leaf found: no leaf
    recomputed, no program compiled), with OOM markers read the same way."""
    jspec, tspec, tree, loader, stats = _model("llama")
    jcfg, tcfg = _cfgs()
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    ref = tsens.calib_sensitivity_ppl(_port(tree, tspec), tspec, loader, tcfg,
                                      stats=_tstats(stats))
    for li, name in enumerate(ref):
        jsens._append_resume(jpath, name, li // 7, 0.5, {r: p * 1.5 for r, p in
                                                         ref[name].items()})
    log = []
    got = _scan(tree, tspec, loader, stats, tcfg, jpath, log)
    assert not log and list(got) == list(ref)
    assert got == {n: {r: p * 1.5 for r, p in d.items()} for n, d in ref.items()}
    out = _scan(tree, tspec, loader, stats, tcfg, tpath)
    back = jsens.calib_sensitivity_ppl(jax.tree.map(jnp.asarray, tree), jspec, loader,
                                       jcfg, stats=_jstats(stats), batch_ratios=True,
                                       resume=tpath)
    assert back == out and list(back) == list(out)
    for append in (jsens._append_oom, tsens._append_oom):
        append(tpath, "model.layers.0.mlp.up_proj", 2, (48, 32))
    tsens._append_resume(tpath, "x", 3, 1.234, {0.4: 2.5, 0.1 * 3: float("inf")})
    with open(tpath, "a") as f:
        f.write('{"name": "y", "li": 0, "dt"')
    j, t = jsens._load_resume(tpath), tsens._load_resume(tpath)
    assert j == t and t[1] == {"model.layers.0.mlp.up_proj": 2} and t[2] == {(48, 32)}
    assert t[0]["x"] == (3, 1.23, {0.4: 2.5, 0.1 * 3: float("inf")})


# ----------------------------------------------------------- OOM ladder ---

def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")


def test_oom_once_retries_on_gram_with_chunks_shrunk(tmp_path):
    path = str(tmp_path / "scan.jsonl")
    calls, fail = [], [1]

    def call(backend, shrink):
        calls.append((backend, shrink))
        if fail[0]:
            fail[0] -= 1
            raise _oom()
        return "ok"
    counts, shapes = {}, set()
    assert tsens._grid_eval_oom_safe(call, "a", path, counts, (48, 32), shapes) == "ok"
    assert calls == [(None, 1), ("gram", 4)]
    assert shapes == {(48, 32)} and counts == {}
    assert tsens._load_resume(path) == ({}, {"a": 0}, {(48, 32)})
    # the shape is generalised: another leaf of it starts on gram, 4x
    calls.clear()
    assert tsens._grid_eval_oom_safe(call, "b", path, counts, (48, 32), shapes) == "ok"
    assert calls == [("gram", 4)]


def test_oom_twice_writes_the_marker_and_raises(tmp_path):
    path = str(tmp_path / "scan.jsonl")
    calls = []

    def call(backend, shrink):
        calls.append((backend, shrink))
        raise _oom()
    counts, shapes = {}, set()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tsens._grid_eval_oom_safe(call, "a", path, counts, (48, 32), shapes)
    assert calls == [(None, 1), ("gram", 4)] and counts == {"a": 1}
    assert tsens._load_resume(path) == ({}, {"a": 1}, {(48, 32)})
    with open(path) as f:
        assert [json.loads(ln) for ln in f] == [
            {"name": "a", "oom": 0, "shape": [48, 32]},
            {"name": "a", "oom": 1, "shape": [48, 32]}]
    # other errors pass through untouched
    with pytest.raises(ValueError):
        tsens._grid_eval_oom_safe(lambda b, s: (_ for _ in ()).throw(ValueError()),
                                  "c", path, {}, (1, 1), set())


def test_scan_takes_the_ladder_and_host_eigh(tmp_path, monkeypatch):
    """Through the whole scan: an injected OOM in the first up_proj's SVD
    sends it and every later leaf of its shape to the Gram path; a leaf
    marked 4 times in the resume file takes the host eigendecomposition;
    the dict stays within rtol 1e-4 of the exact scan's."""
    _, tspec, tree, loader, stats = _model("llama")
    _, tcfg = _cfgs()
    ref = _scan(tree, tspec, loader, stats, tcfg, None)
    path = str(tmp_path / "scan.jsonl")
    tsens._append_oom(path, "model.layers.1.self_attn.o_proj", 4)
    real = tsens._grid_factors
    seen = []

    def factors(w, scale, ranks, backend, generator):
        seen.append((tuple(w.shape), backend))
        if tuple(w.shape) == (48, 32) and backend != "gram":
            raise _oom()
        return real(w, scale, ranks, backend, generator)
    monkeypatch.setattr(tsens, "_grid_factors", factors)
    before = tsvd.host_eigh_calls
    log = []
    out = _scan(tree, tspec, loader, stats, tcfg, path, log)
    _assert_same_dict(out, ref, rtol=1e-4)
    assert tsvd.host_eigh_calls == before + 1
    backends = {r["name"]: r["backend"] for r in log}
    assert backends["model.layers.1.self_attn.o_proj"] == "gram"
    ups = [n for n in backends if n.endswith(("gate_proj", "up_proj"))]
    assert ups and all(backends[n] == "gram" for n in ups)
    assert seen.count(((48, 32), "exact")) == 1   # only the first one tried exact
    assert (48, 32) in tsens._load_resume(path)[2]


# ------------------------------------------------- factor checkpoints ---

@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_factor_checkpoints_read_both_ways(tmp_path, monkeypatch, writer, reader):
    """The final pass's ``<name>.npz`` files: written by one package, read
    by the other (or by a port rerun, which factorizes nothing) with the
    same manifest and the writer's factors bit for bit."""
    jspec, tspec, tree, loader, stats = _model("llama")
    jcfg, tcfg = _cfgs(param_ratio_target=0.8)
    sens = tsens.calib_sensitivity_ppl(_port(tree, tspec), tspec, loader, tcfg,
                                       stats=_tstats(stats))
    rdir = str(tmp_path / "scan.jsonl.factors")

    def search(pkg):
        if pkg == "jax":
            p, man = jsearch.binary_search_truncation_rank(
                jax.tree.map(jnp.asarray, tree), jspec, sens, loader, jcfg,
                stats=_jstats(stats), resume_dir=rdir)
            return man, lambda n: [np.asarray(jregistry.get_linear(p, jspec, n)[k])
                                   for k in "AB"]
        p, man = tsearch.binary_search_truncation_rank(
            _port(tree, tspec), tspec, sens, loader, tcfg, stats=_tstats(stats),
            resume_dir=rdir)
        return man, lambda n: [get_linear(p, tspec, n)[k].numpy() for k in "AB"]

    wman, wfac = search(writer)
    assert sorted(os.listdir(rdir)) == sorted(n + ".npz" for n in wman)
    if reader == "port":
        def no_svd(*a, **k):
            raise AssertionError("a checkpointed leaf was recomputed")
        monkeypatch.setattr(tsearch, "scaled_svd", no_svd)
    rman, rfac = search(reader)
    assert rman == wman and list(rman) == list(wman)
    for name in wman:
        for got, want in zip(rfac(name), wfac(name)):
            np.testing.assert_array_equal(got, want)


def test_torn_and_bf16_factor_checkpoints(tmp_path):
    """A torn checkpoint is recomputed; a bf16 one written by the JAX
    package (ml_dtypes records) is read bit for bit."""
    import ml_dtypes
    like = torch.zeros(4, dtype=torch.bfloat16)
    torn = str(tmp_path / "torn.npz")
    with open(torn, "wb") as f:
        f.write(b"PK\x03\x04 not a zip")
    assert tsearch.load_factors(torn, like) is None
    assert tsearch.load_factors(str(tmp_path / "missing.npz"), like) is None
    rng = np.random.RandomState(0)
    a = rng.randn(6, 2).astype(ml_dtypes.bfloat16)
    b = rng.randn(2, 5).astype(ml_dtypes.bfloat16)
    path = str(tmp_path / "bf16.npz")
    np.savez(path, a=a, b=b, rank=np.int64(2))
    leaf, rank = tsearch.load_factors(path, like)
    assert rank == 2 and leaf["A"].dtype == torch.bfloat16 and leaf["b"] is None
    np.testing.assert_array_equal(leaf["A"].float().numpy(), a.astype(np.float32))
    np.testing.assert_array_equal(leaf["B"].float().numpy(), b.astype(np.float32))


# ----------------------------------------------------------- pipeline ---

def test_compress_resumes_from_scan_resume_path(tmp_path):
    """``scan_resume_path`` through ``pipeline.compress`` on the CPU: the
    scan's JSONL and the search's ``.factors`` checkpoints are written, and
    a rerun with the JSONL cut to half its lines recomputes only the
    missing leaves and gives the same sensitivity dict and manifest.
    ``max_host_rss_gb`` still raises, naming ROADMAP item 8."""
    _, tspec, tree, _, _ = _model("llama")
    path = str(tmp_path / "scan.jsonl")
    cfg = tconfig.ASVDConfig(model_id="tiny", param_ratio_target=0.8, rank_align=2,
                             act_aware=True, calib_dataset="synthetic",
                             n_calib_samples=3, seqlen=SEQLEN, use_cache=False,
                             cache_dir=str(tmp_path / "cache"),
                             scan_resume_path=path)
    tpipe.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="hostguard.*ROADMAP queue 1, item 8"):
        tpipe.check_supported(cfg.replace(max_host_rss_gb=4.0))
    _, man, art = tpipe.compress(_port(tree, tspec), tspec, None, cfg)
    assert man and sorted(os.listdir(path + ".factors")) == sorted(n + ".npz" for n in man)
    with open(path) as f:
        lines = f.readlines()
    with open(path, "w") as f:
        f.writelines(lines[:len(lines) // 2])
    log = []
    _, man2, art2 = tpipe.compress(_port(tree, tspec), tspec, None, cfg, scan_log=log)
    assert man2 == man and art2["sensitivity"] == art["sensitivity"]
    assert len(log) == len(lines) - len(lines) // 2
