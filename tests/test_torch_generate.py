"""PyTorch port vs JAX package: one-token attention, prefill and decode
steps in all three cache modes (dense, "kv" latent, "v" latent), with and
without the fused kernels, in float32 on the CPU.

The JAX latent kernel runs in interpret mode (its core is monkeypatched
for the test, as the JAX package's own kernel test does); the port's
kernels take their plain versions on CPU tensors.
Tolerance: atol/rtol 1e-4 on attention outputs and logits; caches 1e-5.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import asvd4llm_tpu.ops.pallas_latent_attention as pla  # noqa: E402
from asvd4llm_tpu.eval import generate as jgen  # noqa: E402
from asvd4llm_tpu_torch.eval import generate as tgen  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from asvd4llm_tpu_torch.ops import latent_attention as la  # noqa: E402
from test_torch_decoder import BASE, both_specs, random_tree  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
# layer 0: k and v low-rank ("kv"-latent), layer 1: v only ("v"-latent in
# mode "v", dense in mode "kv"); q/down low-rank for the fused linear
LOWRANK = ((0, "k_proj"), (0, "v_proj"), (0, "q_proj"), (1, "v_proj"),
           (1, "down_proj"))


@pytest.fixture(scope="module")
def model():
    jspec, tspec = both_specs("llama_spec", **dict(
        BASE, num_heads=4, num_kv_heads=2, head_dim=8, norm_eps=1e-5))
    tree = random_tree(jspec, seed=11, lowrank=LOWRANK)
    return jspec, tspec, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, tspec)


@pytest.fixture
def jax_kernel_interpret(monkeypatch):
    """Run the JAX latent kernel in interpret mode; count its calls."""
    calls = []
    orig = pla._latent_attention_core

    def interp(*a, **kw):
        calls.append(1)
        return orig(*a, **dict(kw, interpret=True))
    monkeypatch.setattr(pla, "_latent_attention_core", interp)
    return calls


def _caches(jspec, tspec, jp, tp, B, T, mode, rng):
    """Random-filled caches of the same values for both packages."""
    jc = jgen.init_caches(jp, jspec, B, T, dtype=jnp.float32, latent=mode)
    np_c = [{k: rng.randn(*v.shape).astype(np.float32) * 0.3 for k, v in c.items()}
            for c in jc]
    return ([{k: jnp.asarray(v) for k, v in c.items()} for c in np_c],
            [{k: torch.from_numpy(v.copy()) for k, v in c.items()} for c in np_c])


@pytest.mark.parametrize("mode", [False, "kv", "v"])
@pytest.mark.parametrize("up", [False, True])
def test_attend_step_matches_jax(model, jax_kernel_interpret, mode, up):
    jspec, tspec, jp, tp = model
    rng = np.random.RandomState(12)
    B, T, pos = 2, 24, 17
    jc, tc = _caches(jspec, tspec, jp, tp, B, T, mode, rng)
    x = rng.randn(B, 1, 32).astype(np.float32)
    jcos, jsin = jgen.rope_cos_sin(jnp.arange(T), 8, jspec.rope_theta)
    tcos, tsin = tgen.rope_cos_sin(torch.arange(T), 8, tspec.rope_theta)
    n0 = la.latent_decode_attention.launches
    for li in range(2):
        ref, ref_cache = jgen._attend_step(jspec, jp["layers"][li], jnp.asarray(x),
                                           jc[li], pos, jcos, jsin, li, up=up)
        out, cache = tgen._attend_step(tspec, tp["layers"][li], torch.from_numpy(x),
                                       tc[li], pos, tcos, tsin, li, up=up)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        assert set(cache) == set(ref_cache)
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(ref_cache[k]),
                                       atol=1e-5, rtol=1e-5)
    # the fused latent path ran on both sides exactly when it should (the
    # CPU launch counter stays put: the plain version is no launch)
    assert bool(jax_kernel_interpret) == (up and mode == "kv")
    assert la.latent_decode_attention.launches == n0


@pytest.mark.parametrize("mode", [False, "kv", "v"])
def test_prefill_and_decode_steps_match_jax(model, jax_kernel_interpret, mode):
    jspec, tspec, jp, tp = model
    rng = np.random.RandomState(13)
    B, S, T = 2, 9, 16
    ids = rng.randint(0, 96, (B, S + 2))
    jc = jgen.init_caches(jp, jspec, B, T, dtype=jnp.float32, latent=mode)
    tc = tgen.init_caches(tp, tspec, B, T, dtype=torch.float32, latent=mode)
    ref, jc = jgen.prefill_host(jp, jspec, jnp.asarray(ids[:, :S]), jc, latent=mode)
    out, tc = tgen.prefill_host(tp, tspec, torch.from_numpy(ids[:, :S]), tc,
                                latent=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    for step in range(2):
        tok = ids[:, S + step:S + step + 1]
        ref, jc = jgen.decode_step(jp, jspec, jnp.asarray(tok), jc, S + step,
                                   use_pallas=True)
        out, tc = tgen.decode_step(tp, tspec, torch.from_numpy(tok), tc, S + step,
                                   use_pallas=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        plain, _ = tgen.decode_step(
            tp, tspec, torch.from_numpy(tok),
            [{k: v.clone() for k, v in c.items()} for c in tc], S + step)
        np.testing.assert_allclose(plain.numpy(), out.numpy(), **TOL)
    for jcache, tcache in zip(jc, tc):
        for k in tcache:
            np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                       atol=1e-5, rtol=1e-5)
