"""PyTorch port vs JAX package: the compression math. Factorization, rank
formula, cache keys, the serial sensitivity scan, the stable-rank proxy and
the binary search, on a tiny Llama in float32 on the CPU with the exact SVD
on both sides.

Tolerances: reconstructions and singular values rtol 1e-4; sensitivity PPLs
rtol 1e-4; rank formula, cache keys and manifests exactly equal.
"""

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
from asvd4llm_tpu.ops import asvd as jasvd  # noqa: E402
from asvd4llm_tpu_torch import config as tconfig  # noqa: E402
from asvd4llm_tpu_torch.calib import search as tsearch  # noqa: E402
from asvd4llm_tpu_torch.calib import sensitivity as tsens  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from asvd4llm_tpu_torch.models.registry import get_linear, iter_linears  # noqa: E402
from asvd4llm_tpu_torch.ops import asvd as tasvd  # noqa: E402
from test_torch_decoder import BASE, both_specs, random_tree  # noqa: E402


@pytest.mark.parametrize("in_f,out_f,ratio,align", [
    (4096, 4096, 0.9, 128), (4096, 11008, 0.9, 128), (768, 768, 1.4, 128),
    (64, 32, 0.1 * 3, 1), (5, 3, 0.4, 1), (4096, 32000, 0.7, 8)])
def test_rank_formula_equal(in_f, out_f, ratio, align):
    assert tasvd.rank_for_param_ratio(in_f, out_f, ratio, align) == \
        jasvd.rank_for_param_ratio(in_f, out_f, ratio, align)


@pytest.mark.parametrize("kw", [
    {}, dict(model_id="x/y", seqlen=256, rank_align=128, act_aware=True),
    dict(compress_kv_cache=True, kv_cache_ratio_target=0.5, svd_backend="exact"),
])
def test_config_keys_equal(kw):
    j, t = jconfig.ASVDConfig(**kw), tconfig.ASVDConfig(**kw)
    assert t.to_dict() == j.to_dict()
    assert t.calib_key() == j.calib_key()
    assert t.sensitivity_key() == j.sensitivity_key()


@pytest.mark.parametrize("shape,ratio,fuse", [
    ((48, 32), 0.6, "UV"), ((32, 80), 0.9, "U"), ((40, 40), 0.3, "V")])
def test_factorize_linear_matches_jax(shape, ratio, fuse):
    rng = np.random.RandomState(0)
    w = rng.randn(*shape).astype(np.float32)
    bias = rng.randn(shape[0]).astype(np.float32)
    stat = np.abs(rng.randn(shape[1])).astype(np.float32) + 0.1
    kw = dict(act_aware=True, alpha=0.5, sigma_fuse=fuse, rank_align=2,
              backend="exact")
    fj = jasvd.factorize_linear(jnp.asarray(w), jnp.asarray(bias), ratio,
                                scaling_diag=jnp.asarray(stat), **kw)
    ft = tasvd.factorize_linear(torch.from_numpy(w), torch.from_numpy(bias), ratio,
                                scaling_diag=torch.from_numpy(stat), **kw)
    assert ft.rank == fj.rank
    np.testing.assert_allclose(ft.recompose().numpy(), np.asarray(fj.recompose()),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ft.bias.numpy(), bias)
    # singular values of the scaled weight, sign-free by construction
    scale = tasvd.build_scaling_vector(torch.from_numpy(stat), None, 0.5)
    sj = np.linalg.svd(w * np.asarray(jasvd.build_scaling_vector(
        jnp.asarray(stat), None, 0.5))[None, :], compute_uv=False)
    st = torch.linalg.svdvals(torch.from_numpy(w) * scale[None, :]).numpy()
    np.testing.assert_allclose(st, sj, rtol=1e-4)


def test_factorize_keep_dense_cases():
    w = torch.ones(8, 8)
    assert tasvd.factorize_linear(w, None, 0.01) is None        # rank 0
    w_nan = torch.eye(8)
    w_nan[2, 3] = float("nan")
    assert tasvd.factorize_linear(w_nan, None, 0.5, backend="exact") is None
    assert jasvd.factorize_linear(jnp.asarray(w_nan.numpy()), None, 0.5,
                                  backend="exact") is None
    # a NaN leaf in the sensitivity scan's recomposition is skipped, not raised
    leaves = tsens.recomposed_dense_all_ratios(
        w_nan, None, tsens.WEIGHT_RATIO_GRID, None, 1, "exact", None)
    assert all(v is None for v in leaves.values())


@pytest.fixture(scope="module")
def tiny():
    jspec, tspec = both_specs("llama_spec", **dict(
        BASE, num_heads=4, num_kv_heads=2, head_dim=8, norm_eps=1e-5))
    tree = random_tree(jspec, seed=21)
    rng = np.random.RandomState(22)
    loader = [{"input_ids": rng.randint(0, 96, (1, 24))} for _ in range(3)]
    # the same act-aware statistics for both packages
    stats = {n: (np.abs(rng.randn(leaf["w"].shape[1])) + 0.2).astype(np.float32)
             for n, leaf in iter_linears(params_from_numpy(tree, tspec), tspec,
                                         include_extras=True)}
    return jspec, tspec, tree, loader, stats


def _cfgs(**kw):
    kw = dict(dict(alpha=0.5, rank_align=2, n_calib_samples=3, seqlen=24,
                   svd_backend="exact", act_aware=True, use_cache=False), **kw)
    return jconfig.ASVDConfig(**kw), tconfig.ASVDConfig(**kw)


def test_sensitivity_ppl_scan_matches_jax(tiny, tmp_path):
    jspec, tspec, tree, loader, stats = tiny
    jcfg, tcfg = _cfgs(cache_dir=str(tmp_path))
    ref = jsens.calib_sensitivity_ppl(
        jax.tree.map(jnp.asarray, tree), jspec, loader, jcfg,
        stats={k: jnp.asarray(v) for k, v in stats.items()}, batch_ratios=False)
    out = tsens.calib_sensitivity_ppl(
        params_from_numpy(tree, tspec), tspec, loader, tcfg,
        stats={k: torch.from_numpy(v) for k, v in stats.items()})
    assert list(out) == list(ref)
    for name in ref:
        assert list(out[name]) == list(ref[name])
        np.testing.assert_allclose(list(out[name].values()),
                                   list(ref[name].values()), rtol=1e-4,
                                   err_msg=name)


def test_sensitivity_stable_rank_matches_jax(tiny):
    jspec, tspec, tree, loader, _ = tiny
    jcfg, tcfg = _cfgs()
    ref = jsens.calib_sensitivity_stable_rank(jax.tree.map(jnp.asarray, tree),
                                              jspec, loader, jcfg)
    out = tsens.calib_sensitivity_stable_rank(params_from_numpy(tree, tspec),
                                              tspec, loader, tcfg)
    assert set(out) == set(ref)
    for name in ref:
        np.testing.assert_allclose(list(out[name].values()),
                                   list(ref[name].values()), rtol=1e-4)


def _sensitivity_dict(tspec, tree, grid, seed):
    """A random sensitivity dict with exact ties (several ratios share a
    PPL, as rank_align aliasing makes them) and an inf entry."""
    rng = np.random.RandomState(seed)
    names = [n for n, _ in iter_linears(params_from_numpy(tree, tspec), tspec,
                                        include_extras=True)]
    sens = {}
    for n in names:
        vals = np.round(10 + 5 * rng.rand(len(grid)), 1)
        sens[n] = {r: float(v) for r, v in zip(grid, vals)}
    sens[names[3]][grid[0]] = float("inf")
    return sens


@pytest.mark.parametrize("mode", ["weight", "ppl", "kv"])
def test_search_manifest_identical(tiny, mode):
    jspec, tspec, tree, loader, stats = tiny
    if mode == "kv":
        grid, kw = jsens.KV_RATIO_GRID, dict(compress_kv_cache=True,
                                             kv_cache_ratio_target=0.55)
    elif mode == "ppl":
        grid, kw = jsens.WEIGHT_RATIO_GRID, dict(ppl_target=250.0)
    else:
        grid, kw = jsens.WEIGHT_RATIO_GRID, dict(param_ratio_target=0.8)
    assert grid == (tsens.KV_RATIO_GRID if mode == "kv" else tsens.WEIGHT_RATIO_GRID)
    sens = _sensitivity_dict(tspec, tree, grid, seed=23)
    jcfg, tcfg = _cfgs(**kw)
    jp, jman = jsearch.binary_search_truncation_rank(
        jax.tree.map(jnp.asarray, tree), jspec, sens, loader, jcfg,
        stats={k: jnp.asarray(v) for k, v in stats.items()})
    tp, tman = tsearch.binary_search_truncation_rank(
        params_from_numpy(tree, tspec), tspec, sens, loader, tcfg,
        stats={k: torch.from_numpy(v) for k, v in stats.items()})
    assert tman and tman == jman
    assert list(tman) == list(jman)
    for name in tman:
        ja = jregistry.get_linear(jp, jspec, name)
        ta = get_linear(tp, tspec, name)
        np.testing.assert_allclose(
            (ta["A"] @ ta["B"]).numpy(), np.asarray(ja["A"] @ ja["B"]),
            rtol=1e-4, atol=1e-4)
