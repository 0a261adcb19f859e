"""PyTorch port vs JAX package: the decoder forward of every family and the
calibration statistics, in float32 on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: logits atol/rtol 1e-4 (both run true-f32 contractions; the
difference is summation order); statistics rtol 1e-5 with atol 1e-6 for
entries near 0 (post-ReLU inputs, where f32 rounding of O(1) sums is
~1e-7 absolute).
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from asvd4llm_tpu.calib.stats import calib_input_distribution as j_stats  # noqa: E402
from asvd4llm_tpu.models import decoder as jdec  # noqa: E402
from asvd4llm_tpu.models import spec as jspec_mod  # noqa: E402
from asvd4llm_tpu.models.init import init_params as j_init  # noqa: E402
from asvd4llm_tpu_torch.calib.stats import calib_input_distribution as t_stats  # noqa: E402
from asvd4llm_tpu_torch.models import decoder as tdec  # noqa: E402
from asvd4llm_tpu_torch.models import spec as tspec_mod  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy  # noqa: E402

ATOL = RTOL = 1e-4


def random_tree(jspec, seed, lowrank=(), proj_dim=0):
    """Numpy params for `jspec`: the JAX init's layout, every array redrawn
    (norm weights near 1, biases nonzero); linears named in `lowrank`
    ((layer, key) pairs) become {A, B, b} leaves."""
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(np.asarray, j_init(jspec, jax.random.PRNGKey(seed),
                                           dtype=jnp.float32))

    def redraw(path, a):
        names = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if any(str(n).startswith("ln") or n == "final_norm" for n in names) \
                and names[-1] == "w":
            return (1.0 + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return (rng.randn(*a.shape) * max(float(a.std()), 0.05)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(redraw, tree)
    for li, key in lowrank:
        leaf = tree["layers"][li][key]
        out_f, in_f = leaf["w"].shape
        r = max(2, min(out_f, in_f) // 3)
        tree["layers"][li][key] = {
            "A": (rng.randn(out_f, r) * r ** -0.5).astype(np.float32),
            "B": (rng.randn(r, in_f) * in_f ** -0.5).astype(np.float32),
            "b": leaf["b"]}
    if proj_dim:
        H = jspec.hidden_size
        tree["embed_tokens"] = (rng.randn(jspec.vocab_size, proj_dim) * 0.05
                                ).astype(np.float32)
        tree["project_in"] = {"w": (rng.randn(H, proj_dim) * proj_dim ** -0.5
                                    ).astype(np.float32), "b": None}
        tree["project_out"] = {"w": (rng.randn(proj_dim, H) * H ** -0.5
                                     ).astype(np.float32), "b": None}
    return tree


def both_specs(ctor, **kw):
    return getattr(jspec_mod, ctor)(**kw), getattr(tspec_mod, ctor)(**kw)


def both_logits(jspec, tspec, tree, ids):
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tspec, dtype=torch.float32, device="cpu")
    ref = np.asarray(jdec.forward(jp, jnp.asarray(ids), jspec))
    out = tdec.forward(tp, torch.as_tensor(ids), tspec).numpy()
    return out, ref


BASE = dict(vocab_size=96, hidden_size=32, intermediate_size=48, num_layers=2,
            max_position_embeddings=64)
MIXED = ((0, "q_proj"), (0, "v_proj"), (1, "down_proj"), (1, "o_proj"))
OPT_MIXED = ((0, "fc1"), (1, "out_proj"), (1, "k_proj"))

CASES = {
    "llama_gqa2": ("llama_spec", dict(BASE, num_heads=4, num_kv_heads=2,
                                      head_dim=8, norm_eps=1e-5), MIXED, 0),
    "mistral_sliding": ("llama_spec", dict(BASE, num_heads=4, num_kv_heads=1,
                                           head_dim=8, sliding_window=5,
                                           sliding_pattern=1), MIXED, 0),
    "gemma2": ("gemma2_spec", dict(BASE, num_heads=4, num_kv_heads=2,
                                   head_dim=8, embed_scale=32 ** 0.5,
                                   attn_scale=8 ** -0.5,
                                   attn_logit_softcap=5.0,
                                   final_logit_softcap=3.0,
                                   sliding_window=6), MIXED, 0),
    "opt_prenorm": ("opt_spec", dict(BASE, num_heads=4, num_kv_heads=4,
                                     head_dim=8), OPT_MIXED, 0),
    "opt_postnorm_project": ("opt_spec", dict(BASE, num_heads=4, num_kv_heads=4,
                                              head_dim=8, word_embed_proj_dim=16,
                                              do_layer_norm_before=False,
                                              final_norm=False), OPT_MIXED, 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    ctor, kw, lowrank, proj = CASES[case]
    jspec, tspec = both_specs(ctor, **kw)
    tree = random_tree(jspec, seed=1, lowrank=lowrank, proj_dim=proj)
    ids = np.random.RandomState(2).randint(0, kw["vocab_size"], (2, 13))
    out, ref = both_logits(jspec, tspec, tree, ids)
    assert out.shape == (2, 13, kw["vocab_size"]) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", ["llama_gqa2", "gemma2"])
def test_blocked_attention_matches_jax(case, monkeypatch):
    """The online-softmax key-blocked path, forced at a small S in both
    packages (and compared with the unblocked port forward too)."""
    ctor, kw, lowrank, proj = CASES[case]
    jspec, tspec = both_specs(ctor, **kw)
    tree = random_tree(jspec, seed=3, lowrank=lowrank, proj_dim=proj)
    ids = np.random.RandomState(4).randint(0, kw["vocab_size"], (2, 19))
    unblocked, _ = both_logits(jspec, tspec, tree, ids)
    for mod in (jdec, tdec):
        monkeypatch.setattr(mod, "_BLOCK_MIN_SQ", 8)
        monkeypatch.setattr(mod, "_BLOCK_SIZE", 4)
    out, ref = both_logits(jspec, tspec, tree, ids)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, unblocked, atol=ATOL, rtol=RTOL)


def test_spec_from_config_json_matches_jax():
    """The port builds its spec from a config.json dict; the JAX package
    from a transformers config object of the same values."""
    transformers = pytest.importorskip("transformers")
    cfg = dict(model_type="gemma2", vocab_size=96, hidden_size=32,
               intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=8, max_position_embeddings=64,
               rms_norm_eps=1e-6, query_pre_attn_scalar=8,
               attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
               sliding_window=16)
    jspec = jspec_mod.spec_from_hf_config(transformers.Gemma2Config(**cfg))
    tspec = tspec_mod.spec_from_hf_config(cfg)
    assert jspec.__dict__ == tspec.__dict__


@pytest.mark.parametrize("method", ["abs_mean", "abs_max"])
def test_calib_stats_match_jax(method):
    ctor, kw, lowrank, proj = CASES["opt_postnorm_project"]
    jspec, tspec = both_specs(ctor, **kw)
    tree = random_tree(jspec, seed=5, lowrank=lowrank, proj_dim=proj)
    rng = np.random.RandomState(6)
    loader = [{"input_ids": rng.randint(0, 96, (1, L))} for L in (12, 12, 9)]
    ref = j_stats(jax.tree.map(jnp.asarray, tree), jspec, loader, method)
    out = t_stats(params_from_numpy(tree, tspec), tspec, loader, method)
    assert set(out) == set(ref)
    assert "lm_head" in out and "model.decoder.project_in" in out
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
