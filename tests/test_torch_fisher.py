"""PyTorch port vs JAX package: Fisher calibration (calib/fisher.py) and
the compression runs that scale by it, on the CPU in float32.

Tolerances: Fisher vectors rtol 5e-4, atol 1e-7 (the JAX package's own bar
between its whole-model and layer-streamed paths, tests/test_hostmem.py);
rank manifests exactly equal; final PPL rtol 1e-3 (as the abs-stats runs
in test_torch_e2e.py).
"""

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from asvd4llm_tpu.calib.fisher import calib_fisher_info as jfisher  # noqa: E402
from asvd4llm_tpu.models.init import init_params as jinit  # noqa: E402
from asvd4llm_tpu.models.spec import spec_from_hf_config as jspec_from  # noqa: E402
from asvd4llm_tpu_torch.calib.fisher import calib_fisher_info  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from asvd4llm_tpu_torch.models.decoder import forward_hidden  # noqa: E402
from asvd4llm_tpu_torch.models.registry import iter_linears  # noqa: E402
from asvd4llm_tpu_torch.models.spec import DecoderSpec  # noqa: E402
from asvd4llm_tpu_torch.utils.cache import ArtifactCache  # noqa: E402
from test_torch_e2e import _run_both, ckpt  # noqa: E402,F401

RTOL, ATOL = 5e-4, 1e-7

CONFIGS = {
    "llama": {"model_type": "llama", "vocab_size": 96, "hidden_size": 32,
              "intermediate_size": 64, "num_hidden_layers": 2,
              "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8,
              "max_position_embeddings": 64, "rms_norm_eps": 1e-5,
              "tie_word_embeddings": False},
    "gemma": {"model_type": "gemma", "vocab_size": 96, "hidden_size": 32,
              "intermediate_size": 64, "num_hidden_layers": 2,
              "num_attention_heads": 4, "num_key_value_heads": 1, "head_dim": 8,
              "max_position_embeddings": 64, "rms_norm_eps": 1e-6},
    "opt": {"model_type": "opt", "vocab_size": 96, "hidden_size": 32,
            "ffn_dim": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
            "max_position_embeddings": 64, "do_layer_norm_before": True,
            "activation_function": "relu", "tie_word_embeddings": True},
}


def _both(family, seed=3):
    """(JAX params, JAX spec, port params, port spec) with the same f32
    weights."""
    jspec = jspec_from(SimpleNamespace(**CONFIGS[family]))
    jp = jinit(jspec, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tspec = DecoderSpec(**dataclasses.asdict(jspec))
    return jp, jspec, params_from_numpy(jax.tree.map(np.asarray, jp)), tspec


def _loader(n=2, S=16, seed=7):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(0, 96, size=(1, S))} for _ in range(n)]


def _assert_matches(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _assert_no_state(tparams):
    for path, t in _tensors(tparams):
        assert t.grad is None and not t.requires_grad, path


def _tensors(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


FISHER_CASES = [  # (id, family, include_extras, double_shift)
    ("llama_untied_extras", "llama", True, False),
    ("llama_untied_layers_only", "llama", False, False),
    ("gemma_tied_head", "gemma", True, False),
    ("opt", "opt", True, False),
    ("llama_double_shift", "llama", True, True),
]


@pytest.mark.parametrize("family,include_extras,double_shift",
                         [c[1:] for c in FISHER_CASES],
                         ids=[c[0] for c in FISHER_CASES])
def test_fisher_matches_jax(family, include_extras, double_shift):
    """The port's Fisher vectors against the JAX package's whole-model
    path, with the same key set; the weights come back with no gradient
    and no requires_grad."""
    jp, jspec, tp, tspec = _both(family)
    loader = _loader()
    ref = jfisher(jp, jspec, loader, include_extras=include_extras,
                  double_shift=double_shift)
    got = calib_fisher_info(tp, tspec, loader, include_extras=include_extras,
                            double_shift=double_shift)
    _assert_matches(got, ref)
    assert ("lm_head" in got) == include_extras
    if family == "gemma":  # tied: the differentiated weight is the embedding
        assert tp["lm_head"] is None and got["lm_head"].shape == (32,)
    _assert_no_state(tp)


def test_fisher_row_chunks_match_jax(monkeypatch):
    """Squaring each gradient in blocks of rows (here 5, so every weight
    takes several blocks, the last one short) gives the JAX vectors."""
    from asvd4llm_tpu_torch.calib import fisher
    monkeypatch.setattr(fisher, "ROW_CHUNK", 5)
    jp, jspec, tp, tspec = _both("gemma")
    loader = _loader()
    _assert_matches(calib_fisher_info(tp, tspec, loader), jfisher(jp, jspec, loader))


def test_fisher_cache_hit_returns_equal_arrays(tmp_path):
    """A second call with the same key loads the first call's vectors from
    the JAX package's file name (fisher_<key>.npz) and runs no backward."""
    _, _, tp, tspec = _both("llama")
    cache = ArtifactCache(str(tmp_path))
    first = calib_fisher_info(tp, tspec, _loader(), cache=cache, cache_key="k1")
    assert os.path.exists(tmp_path / "fisher_k1.npz")
    second = calib_fisher_info(tp, tspec, [], cache=cache, cache_key="k1")
    assert set(second) == set(first)
    for k in first:
        assert torch.equal(second[k], first[k]), k


def test_forward_hidden_remat_gives_every_weight_its_gradient():
    """Under remat (non-reentrant checkpointing) a layer whose input needs
    no gradient still passes gradients to its weights, the same as
    without remat; remat refuses caches and statistics."""
    _, _, tp, tspec = _both("llama")
    ids = torch.as_tensor(_loader(1)[0]["input_ids"])
    ws = [leaf["w"] for _, leaf in iter_linears(tp, tspec)]
    grads = {}
    for remat in (False, True):
        for w in ws:
            w.requires_grad_(True)
        hidden, _ = forward_hidden(tp, ids, tspec, remat=remat)
        grads[remat] = torch.autograd.grad(hidden.square().sum(), ws)
        for w in ws:
            w.requires_grad_(False)
    for g0, g1 in zip(grads[False], grads[True]):
        assert float(g1.abs().max()) > 0
        torch.testing.assert_close(g1, g0, rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="remat"):
        forward_hidden(tp, ids, tspec, remat=True, stats={}, collect="abs_mean")


@pytest.mark.parametrize("method", ["fisher_abs_mean", "fisher"])
def test_fisher_compression_matches_jax(ckpt, tmp_path, method):  # noqa: F811
    """A tiny compression scaled by Fisher (with and without the abs-mean
    statistics) gives the JAX package's rank manifest and PPL."""
    _, _, jman, jres, out = _run_both(ckpt, tmp_path, param_ratio_target=0.8,
                                      rank_align=2, scaling_method=method)
    assert jman and out["manifest"] == jman
    assert list(out["manifest"]) == list(jman)
    np.testing.assert_allclose(out["results"]["synthetic"], jres["synthetic"],
                               rtol=1e-3)
    assert "calib_fisher" in out["phase_times"]
    assert ("calib_stats" in out["phase_times"]) == ("abs" in method)
